"""Shared model building blocks (counterpart of the JAX
package's models/common.py).

Image activations are ``(N, C, D, H, W)`` tensors in
``torch.channels_last_3d`` memory format: the same bytes as the JAX
package's ``(N, D, H, W, C)`` layout, so the DenseNet bottleneck sees a
free ``(voxels, channels)`` view. Only the eval-mode forward is ported.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

CHANNELS_LAST = torch.channels_last_3d
BN_EPS = 1e-5


def require_eval(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train-mode BatchNorm is not ported yet; "
            "call .eval() (see ROADMAP.md)"
        )


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1, with the JAX package's order of
    operations: ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    float32 (common.py:137-139). Parameters and buffers carry torch's names."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        require_eval(self)
        shape = (-1,) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        out = (x.float() - self.running_mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        return out.to(x.dtype)


def conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
         padding: int = 0) -> nn.Conv3d:
    """Bias-free 3D convolution with torch-style integer padding (the JAX
    package's ``conv`` with ``use_bias=False``)."""
    return nn.Conv3d(in_channels, out_channels, kernel, stride=stride,
                     padding=padding, bias=False)


def max_pool(x, window: int, stride: int, padding: int):
    """Max pool with symmetric integer padding (padding counts as -inf)."""
    return F.max_pool3d(x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Average pool, VALID padding."""
    return F.avg_pool3d(x, window, stride)


def global_avg_pool(x):
    """(N, C, D, H, W) -> (N, C)."""
    return x.mean(dim=(2, 3, 4))
