"""18-layer 3D ResNet with narrow planes (counterpart of the JAX package's
models/resnet3d.py:20-74).

A stem ``stem_conv`` with kernel (1, 7, 7), stride (1, 2, 2) and padding
(1, 3, 3) (a depth padding of 1 under a depth-1 kernel, so the depth grows
by 2, as in the JAX model) -> BN -> ReLU; four stages of two
``BasicBlock3D`` (3x3x3 conv with the stride -> BN -> ReLU -> 3x3x3 conv ->
BN, plus a strided 1x1x1 ``downsample_conv`` and ``downsample_bn`` where
the shape changes, then ReLU) with planes 8, 16, 8, 16 and elementwise
dropout (0.2) after each stage; global average pool -> ``fc`` -> sigmoid.
Convolutions take the fan-out kaiming init, ``fc`` ``normal(0.01)``.

The JAX model takes its input channels from the input; here they are
``in_channels``. It has no features or Grad-CAM path; asked for Grad-CAM,
this one raises ``ConfigurationError`` (run ``--inference`` with
``--no_gradcam``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .common import BatchNorm, Dropout, conv, dense, global_avg_pool
from .seresnet import no_gradcam


class BasicBlock3D(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = conv(in_channels, planes, 3, stride=stride, padding=1,
                          dtype=dtype, fan_out_init=True)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = conv(planes, planes, 3, padding=1, dtype=dtype,
                          fan_out_init=True)
        self.bn2 = BatchNorm(planes, dtype)
        if stride != 1 or in_channels != planes:
            self.downsample_conv = conv(in_channels, planes, 1, stride=stride,
                                        padding="SAME", dtype=dtype,
                                        fan_out_init=True)
            self.downsample_bn = BatchNorm(planes, dtype)

    def forward(self, x, sample_mask=None):
        y = F.relu(self.bn1(self.conv1(x), sample_mask))
        y = self.bn2(self.conv2(y), sample_mask)
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x), sample_mask)
        return F.relu(y + x)


STAGES = ((8, 1, 2), (16, 2, 2), (8, 2, 2), (16, 2, 2))


class ResNet3D18(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 dropout_prob: float = 0.2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.stem_conv = conv(in_channels, 64, (1, 7, 7), stride=(1, 2, 2),
                              padding=(1, 3, 3), dtype=dtype,
                              fan_out_init=True)
        self.stem_bn = BatchNorm(64, dtype)
        ch = 64
        for stage, (planes, stride, blocks) in enumerate(STAGES):
            for b in range(blocks):
                self.add_module(
                    f"layer{stage + 1}_block{b + 1}",
                    BasicBlock3D(ch, planes, stride if b == 0 else 1, dtype))
                ch = planes
        self.dropout = Dropout(dropout_prob)
        self.fc = dense(ch, num_classes, dtype, kernel_std=0.01)

    def forward(self, x, sample_mask=None, generator=None,
                capture_gradcam: bool = False):
        """x: (N, D, H, W, C) -> (N, num_classes) in (0, 1)."""
        if capture_gradcam:
            no_gradcam("r3d_18")
        x = F.relu(self.stem_bn(self.stem_conv(x.permute(0, 4, 1, 2, 3)),
                                sample_mask))
        for stage, (_, _, blocks) in enumerate(STAGES):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_block{b + 1}")(
                    x, sample_mask)
            x = self.dropout(x, generator)
        return torch.sigmoid(self.fc(global_avg_pool(x)))
