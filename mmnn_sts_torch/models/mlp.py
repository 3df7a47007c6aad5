"""Clinical-feature MLP encoder (counterpart of the JAX package's
models/mlp.py), eval mode.

Five Linear -> BatchNorm -> ReLU stages (in -> 32 -> 16 -> 8 -> 8 -> 8), a
``features`` stage Linear(8, feature_channels) -> BN -> ReLU, and a linear
``output_head``. Dropout is the identity in eval mode and is left out.
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from .common import BatchNorm, require_eval

_WIDTHS = (32, 16, 8, 8, 8)


class MLP(nn.Module):
    """``out_channels=None`` builds no output head: inside the multimodal
    model the MLP only contributes its features, and the JAX package's MLP
    then has no ``out`` parameters either."""

    def __init__(self, in_channels: int = 1, out_channels: int | None = 3,
                 feature_channels: int = 12):
        super().__init__()
        names = [str(i) for i in range(len(_WIDTHS))] + ["features"]
        widths = list(_WIDTHS) + [feature_channels]
        prev = in_channels
        for name, width in zip(names, widths):
            self.add_module(f"dense_{name}", nn.Linear(prev, width))
            self.add_module(f"bn_{name}", BatchNorm(width))
            prev = width
        if out_channels is not None:
            self.out = nn.Linear(feature_channels, out_channels)

    def _stage(self, x, name):
        return F.relu(getattr(self, f"bn_{name}")(getattr(self, f"dense_{name}")(x)))

    def backbone(self, x):
        for i in range(len(_WIDTHS)):
            x = self._stage(x, str(i))
        return x

    def features(self, x):
        return self._stage(x, "features")

    def output_head(self, x):
        return self.out(x)

    def forward(self, x, return_features: bool = False):
        require_eval(self)
        feats = self.features(self.backbone(x))
        return feats if return_features else self.output_head(feats)
