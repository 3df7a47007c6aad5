"""Reference family ``tinycnn_blend``: the program's ``tinycnn`` image
encoder (the JAX package's TinyCNN) as the image model of the shared
``BlendModel``. Five VALID 3^3 convolutions with bias (64, 32, 32, 16, 16
channels), each followed by BatchNorm and a channel dropout, with no
activation; then the global average pool, the ``features`` Linear and an
elementwise dropout. No fused bottleneck.

The benchmark's tests add it to a temporary root as a file alone, beside
a configuration, a traffic mix and a limits file: a family that the
harness takes without an edit."""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from perfbench.reference.common import (
    BatchNorm, BlendModel, Conv3d, Linear, dropout, operand)

WIDTHS = (64, 32, 32, 16, 16)


class BiasedConv(Conv3d):
    """A VALID 3^3 convolution with a bias."""

    def __init__(self, c_in: int, c_out: int, precision: str):
        super().__init__(c_in, c_out, 3, 1, 0, precision)
        self.bias = nn.Parameter(self.weight.new_zeros(c_out))

    def forward(self, x):
        p = self.precision
        return operand(F.conv3d(operand(x, p), operand(self.weight, p),
                                self.bias), p)


class TinyCNN(nn.Module):
    """x (N, D, H, W, C) -> (N, ``feature_channels``) features."""

    def __init__(self, in_channels, feature_channels, dropout_prob,
                 precision):
        super().__init__()
        prev = in_channels
        for i, width in enumerate(WIDTHS):
            self.add_module(f"conv{i + 1}", BiasedConv(prev, width,
                                                       precision))
            self.add_module(f"bn{i + 1}", BatchNorm(width, precision))
            prev = width
        self.features = Linear(prev, feature_channels, precision)
        self.p_drop = dropout_prob

    def forward(self, x, mask=None, generator=None):
        x = x.movedim(-1, 1)
        for i in range(len(WIDTHS)):
            x = getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(x),
                                            mask)
            if self.training:
                x = dropout(x, self.p_drop, generator, channels=True)
        x = self.features(x.mean(dim=(2, 3, 4)))
        if self.training:
            x = dropout(x, self.p_drop, generator, channels=False)
        return x


def build(model_cfg: dict, precision: str = "float32") -> nn.Module:
    d = model_cfg
    image = TinyCNN(d["in_channels"], d["feature_layers"],
                    d["image_dropout"], precision)
    return BlendModel(image, d["clinical_inputs"], d["feature_layers"],
                      d["classes"], d["clinical_dropout"], precision)


def layers(model_cfg: dict, spatial) -> list[dict]:
    out, side, prev = [], list(spatial), model_cfg["in_channels"]
    for i, width in enumerate(WIDTHS):
        side = [s - 2 for s in side]
        out.append({"name": f"conv{i + 1}",
                    "macs": side[0] * side[1] * side[2] * width * prev * 27,
                    "first": i == 0})
        prev = width
    out.append({"name": "features",
                "macs": prev * model_cfg["feature_layers"], "first": False})
    return out
