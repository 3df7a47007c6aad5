"""Clinical-feature MLP encoder (counterpart of the JAX package's
models/mlp.py).

Five Linear -> BatchNorm -> Dropout -> ReLU stages (in -> 32 -> 16 -> 8 ->
8 -> 8), a ``features`` stage Linear(8, feature_channels) -> BN -> Dropout
-> ReLU, and a linear ``output_head`` (mlp.py:28-54). Dropout is
elementwise, as in the JAX package.
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from .common import BatchNorm, Dropout, dense

_WIDTHS = (32, 16, 8, 8, 8)


class MLP(nn.Module):
    """``out_channels=None`` builds no output head: inside the multimodal
    model the MLP only contributes its features, and the JAX package's MLP
    then has no ``out`` parameters either."""

    def __init__(self, in_channels: int = 1, out_channels: int | None = 3,
                 feature_channels: int = 12, dropout_prob: float = 0.2):
        super().__init__()
        names = [str(i) for i in range(len(_WIDTHS))] + ["features"]
        widths = list(_WIDTHS) + [feature_channels]
        prev = in_channels
        for name, width in zip(names, widths):
            self.add_module(f"dense_{name}", dense(prev, width))
            self.add_module(f"bn_{name}", BatchNorm(width))
            prev = width
        self.dropout = Dropout(dropout_prob)
        if out_channels is not None:
            self.out = dense(feature_channels, out_channels)

    def _stage(self, x, name, sample_mask, generator):
        x = getattr(self, f"bn_{name}")(getattr(self, f"dense_{name}")(x),
                                        sample_mask)
        return F.relu(self.dropout(x, generator))

    def backbone(self, x, sample_mask=None, generator=None):
        for i in range(len(_WIDTHS)):
            x = self._stage(x, str(i), sample_mask, generator)
        return x

    def features(self, x, sample_mask=None, generator=None):
        return self._stage(x, "features", sample_mask, generator)

    def output_head(self, x):
        return self.out(x)

    def forward(self, x, return_features: bool = False, sample_mask=None,
                generator=None):
        feats = self.features(self.backbone(x, sample_mask, generator),
                              sample_mask, generator)
        return feats if return_features else self.output_head(feats)
