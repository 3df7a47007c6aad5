"""Reference family ``densenet``: MONAI's 3D DenseNet of a block
configuration with its vanilla head (ReLU, global average pool, the
``out`` Linear), written from the model's published description
(Huang et al. 2017; MONAI ``DenseNet``). The shared pieces and the
family contract are in ``perfbench.reference.common``.

Semantics followed beyond the shared ones:

* The bottleneck: BatchNorm on the batch statistics, ReLU and a 1x1x1
  convolution, written as a matrix product; its masked rows are not
  zeroed. Its parameters are ``scale``, ``bias``, ``kernel`` (Cin, Cout)
  and running ``mean``, ``var``, as the program's fused bottleneck names
  them.
* Dropout: one draw a dense layer in forward order (a channel dropout),
  then the feature head's, where the model has one.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.common import (
    BN_EPS, BatchNorm, Conv3d, Linear, batch_stats, dropout, fold_running,
    operand, per_channel)


class Bottleneck(nn.Module):
    """BatchNorm (batch statistics in train mode) + ReLU + 1x1x1 conv."""

    def __init__(self, c_in: int, c_out: int, precision: str):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c_in))
        self.bias = nn.Parameter(torch.zeros(c_in))
        self.kernel = nn.Parameter(torch.zeros(c_in, c_out))
        self.register_buffer("mean", torch.zeros(c_in))
        self.register_buffer("var", torch.ones(c_in))
        self.precision = precision

    def forward(self, x, mask=None):
        if self.training:
            mean, var, unbiased, valid = batch_stats(x, mask)
            fold_running(self.mean, self.var, mean.detach(),
                         unbiased.detach(), valid)
        else:
            mean, var = self.mean, self.var
        h = F.relu((x - per_channel(mean, x)) * per_channel(
            torch.rsqrt(var + BN_EPS) * self.scale, x)
            + per_channel(self.bias, x))
        p = self.precision
        rows = h.movedim(1, -1)
        out = operand(operand(rows, p) @ operand(self.kernel, p), p)
        return out.movedim(-1, 1)


class DenseLayer(nn.Module):
    def __init__(self, c_in, growth, bn_size, p_drop, precision):
        super().__init__()
        self.fused1 = Bottleneck(c_in, bn_size * growth, precision)
        self.norm2 = BatchNorm(bn_size * growth, precision)
        self.conv2 = Conv3d(bn_size * growth, growth, 3, 1, 1, precision)
        self.p_drop = p_drop

    def forward(self, x, mask, generator):
        y = self.conv2(F.relu(self.norm2(self.fused1(x, mask), mask)))
        if self.training:
            y = dropout(y, self.p_drop, generator, channels=True)
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, c_in, c_out, precision):
        super().__init__()
        self.norm = BatchNorm(c_in, precision)
        self.conv = Conv3d(c_in, c_out, 1, 1, 0, precision)

    def forward(self, x, mask):
        return F.avg_pool3d(self.conv(F.relu(self.norm(x, mask))), 2, 2)


class DenseNet3D(nn.Module):
    """3D DenseNet of a block configuration (MONAI ``DenseNet``): stem
    conv 7^3 stride 2 + BN + ReLU + max pool 3 stride 2, dense blocks with
    transitions halving channels and side, a final BN; then the feature
    head (ReLU, global average pool, Linear to ``feature_channels``,
    dropout) or, with ``feature_channels=None``, ReLU and the pool alone;
    and the ``out`` Linear where ``out_channels`` is given (without it the
    forward returns the features)."""

    def __init__(self, block_config, in_channels=2, init_features=64,
                 growth_rate=32, bn_size=4, dropout_prob=0.0,
                 feature_channels=12, out_channels=None,
                 precision="float32"):
        super().__init__()
        self.block_config = tuple(block_config)
        self.p_drop = dropout_prob
        self.conv0 = Conv3d(in_channels, init_features, 7, 2, 3, precision)
        self.norm0 = BatchNorm(init_features, precision)
        ch = init_features
        for i, n in enumerate(self.block_config):
            for j in range(n):
                self.add_module(f"block{i + 1}_layer{j + 1}", DenseLayer(
                    ch, growth_rate, bn_size, dropout_prob, precision))
                ch += growth_rate
            if i == len(self.block_config) - 1:
                self.norm5 = BatchNorm(ch, precision)
            else:
                self.add_module(f"transition{i + 1}",
                                Transition(ch, ch // 2, precision))
                ch //= 2
        self.vanilla = feature_channels is None
        if not self.vanilla:
            self.feature_layer = Linear(ch, feature_channels, precision)
            ch = feature_channels
        self.head = out_channels is not None
        if self.head:
            self.out = Linear(ch, out_channels, precision)

    def features(self, x, mask=None, generator=None):
        """x (N, D, H, W, C) -> (N, F) features."""
        x = x.movedim(-1, 1)
        x = F.max_pool3d(F.relu(self.norm0(self.conv0(x), mask)), 3, 2, 1)
        for i, n in enumerate(self.block_config):
            for j in range(n):
                x = getattr(self, f"block{i + 1}_layer{j + 1}")(
                    x, mask, generator)
            if i == len(self.block_config) - 1:
                x = self.norm5(x, mask)
            else:
                x = getattr(self, f"transition{i + 1}")(x, mask)
        x = F.relu(x).mean(dim=(2, 3, 4))
        if self.vanilla:
            return x
        x = self.feature_layer(x)
        if self.training:
            x = dropout(x, self.p_drop, generator, channels=False)
        return x

    def forward(self, x, mask=None, generator=None):
        x = self.features(x, mask, generator)
        return self.out(x) if self.head else x


def arguments(model_cfg: dict, precision: str) -> dict:
    """``DenseNet3D``'s arguments from a configuration's ``model``
    section, but for its head."""
    d = model_cfg
    return dict(block_config=d["block_config"], in_channels=d["in_channels"],
                init_features=d["init_features"],
                growth_rate=d["growth_rate"], bn_size=d["bn_size"],
                dropout_prob=d["image_dropout"], precision=precision)


def build(model_cfg: dict, precision: str = "float32") -> nn.Module:
    return DenseNet3D(feature_channels=None,
                      out_channels=model_cfg["classes"],
                      **arguments(model_cfg, precision))


def encoder_layers(model_cfg: dict, spatial) -> tuple[list, int]:
    """The products of the stem and the dense blocks on one volume, and
    the channels they leave."""
    out = []
    d, h, w = spatial
    c_in, feats = model_cfg["in_channels"], model_cfg["init_features"]
    stem = (d // 2) * (h // 2) * (w // 2)
    out.append({"name": "conv0", "macs": stem * feats * c_in * 7 ** 3,
                "first": True})
    vox = (d // 4) * (h // 4) * (w // 4)
    ch, growth = feats, model_cfg["growth_rate"]
    mid = model_cfg["bn_size"] * growth
    blocks = model_cfg["block_config"]
    for i, n in enumerate(blocks):
        for j in range(n):
            out.append({"name": f"block{i + 1}_layer{j + 1}.bottleneck",
                        "macs": vox * ch * mid, "first": False})
            out.append({"name": f"block{i + 1}_layer{j + 1}.conv2",
                        "macs": vox * mid * growth * 27, "first": False})
            ch += growth
        if i < len(blocks) - 1:
            out.append({"name": f"transition{i + 1}",
                        "macs": vox * ch * (ch // 2), "first": False})
            ch //= 2
            vox //= 8
    return out, ch


def layers(model_cfg: dict, spatial) -> list[dict]:
    out, ch = encoder_layers(model_cfg, spatial)
    out.append({"name": "out", "macs": ch * model_cfg["classes"],
                "first": False})
    return out
