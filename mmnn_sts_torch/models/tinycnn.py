"""TinyCNN: a five-layer 2D or 3D convolution stack (counterpart of the
JAX package's models/tinycnn.py:19-71).

Five VALID 3x3(x3) convolutions with bias (64, 32, 32, 16, 16), each followed
by BatchNorm and channel dropout, with no activation anywhere, as the JAX
model (and the reference it mirrors) has none; then global average pool ->
the ``features`` Linear(feature_channels) -> dropout -> ``out``. The
Grad-CAM target is conv5's output before its BatchNorm (16 channels).

The feature layer keeps the JAX name ``features`` (``convert.py`` maps
name for name), so this model has no ``features()`` method: its head is
``feature_head``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BatchNorm, Dropout, conv, dense, global_avg_pool

_WIDTHS = (64, 32, 32, 16, 16)


class TinyCNN(nn.Module):
    """``out_channels=None`` builds no ``out`` head (the multimodal image
    encoder contributes its features only)."""

    def __init__(self, in_channels: int = 1, out_channels: int | None = 3,
                 feature_channels: int = 12, dropout_prob: float = 0.5,
                 dtype: torch.dtype | None = None, spatial_dims: int = 3):
        super().__init__()
        prev = in_channels
        for i, width in enumerate(_WIDTHS):
            self.add_module(f"conv{i + 1}", conv(
                prev, width, 3, padding="VALID", dtype=dtype, use_bias=True,
                spatial_dims=spatial_dims))
            self.add_module(f"bn{i + 1}", BatchNorm(width, dtype))
            prev = width
        self.channel_dropout = Dropout(dropout_prob, channels=True)
        self.features = dense(prev, feature_channels, dtype)
        self.feature_dropout = Dropout(dropout_prob)
        if out_channels is not None:
            self.out = dense(feature_channels, out_channels, dtype)

    def backbone(self, x, sample_mask=None, generator=None, captured=None):
        """x: (N, C, *spatial). conv5's output goes to ``captured``, where
        one is given."""
        for i in range(len(_WIDTHS)):
            x = getattr(self, f"conv{i + 1}")(x)
            if captured is not None and i == len(_WIDTHS) - 1:
                captured.append(x)
            x = self.channel_dropout(
                getattr(self, f"bn{i + 1}")(x, sample_mask), generator)
        return x

    def feature_head(self, x, generator=None):
        return self.feature_dropout(self.features(global_avg_pool(x)),
                                    generator)

    def forward(self, x, return_features: bool = False, sample_mask=None,
                generator=None, capture_gradcam: bool = False):
        """x: (N, *spatial, C). With ``capture_gradcam``, returns
        ``(out, act)``, ``act`` conv5's output (N, 16, *spatial')."""
        captured = [] if capture_gradcam else None
        feats = self.feature_head(
            self.backbone(x.movedim(-1, 1), sample_mask, generator,
                          captured),
            generator)
        out = feats if return_features else self.out(feats)
        return (out, captured[0]) if capture_gradcam else out
