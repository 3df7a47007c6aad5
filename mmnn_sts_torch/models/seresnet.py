"""Squeeze-and-excitation ResNet-50, 2D or 3D (counterpart of the JAX
package's models/seresnet.py:18-93).

``SEBottleneck``: 1x1(x1) conv -> BN -> ReLU -> 3x3(x3) conv (the block's
stride) -> BN -> ReLU -> 1x1(x1) conv (4 x planes) -> BN -> ``SEBlock``
(global pool -> Linear(C / 16) -> ReLU -> Linear(C) -> sigmoid, scaling the
channels), plus the residual (a strided 1x1(x1) ``downsample_conv`` and
``downsample_bn`` where the shape changes), then ReLU. ``SEResNet50``: a
7x7(x7) stride-2 stem with BN, ReLU and a max pool (3, 2, 1), stages of
[3, 4, 6, 3] blocks with planes 64-512, global average pool, dropout only
where ``dropout_prob`` is set (the registry sets none), and ``fc``.

The JAX model has no features or Grad-CAM path; asked for Grad-CAM, this
one raises ``ConfigurationError`` (run ``--inference`` with
``--no_gradcam``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..exceptions import ConfigurationError
from .common import BatchNorm, Dropout, conv, dense, global_avg_pool, max_pool


def no_gradcam(name: str):
    raise ConfigurationError(
        f"{name} has no Grad-CAM path (the JAX package's has none either); "
        "run --inference with --no_gradcam")


class SEBlock(nn.Module):
    """Squeeze and excitation. On a depth-sharded activation the pool sums
    over the ``space`` ranks, so the channel scales are the whole
    volume's, and they scale this rank's planes: the fully connected
    layers' gradients are partial on each rank and summed with the
    others'."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = dense(channels, channels // reduction, dtype)
        self.fc2 = dense(channels // reduction, channels, dtype)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(global_avg_pool(x)))))
        return x * s.view(s.shape + (1,) * (x.dim() - 2))


class SEBottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 reduction: int = 16, expansion: int = 4,
                 dtype: torch.dtype | None = None, spatial_dims: int = 3):
        super().__init__()
        out = planes * expansion
        kw = dict(dtype=dtype, spatial_dims=spatial_dims)
        self.conv1 = conv(in_channels, planes, 1, padding="SAME", **kw)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = conv(planes, out, 1, padding="SAME", **kw)
        self.bn3 = BatchNorm(out, dtype)
        self.se = SEBlock(out, reduction, dtype)
        if stride != 1 or in_channels != out:
            self.downsample_conv = conv(in_channels, out, 1, stride=stride,
                                        padding="SAME", **kw)
            self.downsample_bn = BatchNorm(out, dtype)

    def forward(self, x, sample_mask=None):
        y = F.relu(self.bn1(self.conv1(x), sample_mask))
        y = F.relu(self.bn2(self.conv2(y), sample_mask))
        y = self.se(self.bn3(self.conv3(y), sample_mask))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x), sample_mask)
        return F.relu(y + x)


STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class SEResNet50(nn.Module):
    def __init__(self, in_channels: int = 2, num_classes: int = 2,
                 dropout_prob: float | None = None,
                 dtype: torch.dtype | None = None, spatial_dims: int = 3):
        super().__init__()
        self.conv0 = conv(in_channels, 64, 7, stride=2, padding=3,
                          dtype=dtype, spatial_dims=spatial_dims)
        self.bn0 = BatchNorm(64, dtype)
        ch = 64
        for stage, (planes, blocks, stride) in enumerate(STAGES):
            for b in range(blocks):
                self.add_module(
                    f"layer{stage + 1}_block{b + 1}",
                    SEBottleneck(ch, planes, stride if b == 0 else 1,
                                 dtype=dtype, spatial_dims=spatial_dims))
                ch = planes * 4
        self.dropout = Dropout(dropout_prob or 0.0)
        self.fc = dense(ch, num_classes, dtype)

    def forward(self, x, sample_mask=None, generator=None,
                capture_gradcam: bool = False):
        """x: (N, *spatial, C) -> (N, num_classes)."""
        if capture_gradcam:
            no_gradcam("seresnet50")
        x = x.movedim(-1, 1)
        x = max_pool(F.relu(self.bn0(self.conv0(x), sample_mask)), 3, 2, 1)
        for stage, (_, blocks, _) in enumerate(STAGES):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_block{b + 1}")(
                    x, sample_mask)
        return self.fc(self.dropout(global_avg_pool(x), generator))
