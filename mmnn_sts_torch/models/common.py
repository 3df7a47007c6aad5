"""Shared model building blocks (counterpart of the JAX
package's models/common.py).

Image activations are ``(N, C, D, H, W)`` tensors in
``torch.channels_last_3d`` memory format: the same bytes as the JAX
package's ``(N, D, H, W, C)`` layout, so the DenseNet bottleneck sees a
free ``(voxels, channels)`` view. Features are dim 1 everywhere, so one
statistics function serves the image and the clinical (N, C) BatchNorms.

Train mode is ``module.training``, as in torch. A ``sample_mask`` (N,) of
0/1 marks the valid samples of a wrap-padded ragged batch; dropout draws
from the ``torch.Generator`` its caller passes.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

CHANNELS_LAST = torch.channels_last_3d
BN_EPS = 1e-5
# running-stat decay (torch momentum 0.1), the JAX package's BN_MOMENTUM
BN_MOMENTUM = 0.9
# stddev of a standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so that the truncated draw keeps variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def kaiming_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """The JAX package's convolution init (common.py:24): N(0, 2 / fan_in)."""
    with torch.no_grad():
        return w.normal_(0.0, (2.0 / fan_in) ** 0.5)


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax ``Dense``'s default kernel init: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def compute_batch_stats(x, mask=None):
    """Per-feature (dim 1) statistics over every other dim, with the JAX
    package's formula (common.py:30-76). Returns ``(mean, var, unbiased,
    any_valid)``:

    * ``var`` is the biased variance ``E[x^2] - mean^2``, clamped at 0
      (float32 cancellation can round it negative);
    * ``unbiased`` is ``var * n / (n - 1)``, what the running variance takes;
    * ``any_valid`` is None without ``mask``; with one (a (N,) 0/1 tensor)
      only valid samples count, and a fully masked batch gives identity
      statistics (mean 0, var 1).
    """
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    zero = xf.new_zeros(())
    if mask is None:
        mean = xf.mean(dims)
        var = torch.maximum(xf.square().mean(dims) - mean.square(), zero)
        n = x.numel() // x.shape[1]
        return mean, var, var * (n / max(n - 1, 1)), None
    mf = mask.float().view((-1,) + (1,) * (x.dim() - 1))
    n_valid = mf.sum() * (x[0, 0].numel())
    denom = torch.clamp(n_valid, min=1.0)
    any_valid = n_valid > 0
    mean = (xf * mf).sum(dims) / denom
    var = torch.maximum((xf.square() * mf).sum(dims) / denom - mean.square(),
                        zero)
    mean = torch.where(any_valid, mean, zero)
    var = torch.where(any_valid, var, torch.ones_like(var))
    unbiased = var * (n_valid / torch.clamp(n_valid - 1.0, min=1.0))
    return mean, var, unbiased, any_valid


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, unbiased,
                         any_valid=None):
    """In place: ``r = 0.9 r + 0.1 batch``, the running variance from the
    unbiased batch variance (torch's rule); a fully masked batch
    (``any_valid`` false) leaves both untouched."""
    m = BN_MOMENTUM
    new_mean = m * running_mean + (1 - m) * mean
    new_var = m * running_var + (1 - m) * unbiased
    if any_valid is not None:
        new_mean = torch.where(any_valid, new_mean, running_mean)
        new_var = torch.where(any_valid, new_var, running_var)
    running_mean.copy_(new_mean)
    running_var.copy_(new_var)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with the JAX package's semantics
    (common.py:79-153): ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    in float32; batch statistics in train mode (then the running-stat
    update, and masked rows of the output zeroed), running statistics in
    eval mode. Parameters and buffers carry torch's names."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, sample_mask=None):
        shape = (-1,) + (1,) * (x.dim() - 2)
        if self.training:
            mean, var, unbiased, any_valid = compute_batch_stats(x, sample_mask)
            update_running_stats(self.running_mean, self.running_var, mean,
                                 unbiased, any_valid)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        out = (x.float() - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        if self.training and sample_mask is not None:
            out = out * sample_mask.float().view((-1,) + (1,) * (x.dim() - 1))
        return out.to(x.dtype)


class Dropout(nn.Module):
    """Dropout in train mode: each element (``channels=False``, flax
    ``nn.Dropout``) or each (sample, channel) (``channels=True``, torch
    Dropout3d, the JAX package's ``ChannelDropout``, common.py:197-212) is
    zeroed with probability ``p`` from ``generator``, the rest scaled by
    1 / (1 - p). The identity in eval mode or at p = 0."""

    def __init__(self, p: float, channels: bool = False):
        super().__init__()
        self.p = p
        self.channels = channels

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        shape = x.shape[:2] + (1,) * (x.dim() - 2) if self.channels else x.shape
        keep = torch.rand(shape, generator=generator, device=x.device) \
            < 1.0 - self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


def conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
         padding: int = 0) -> nn.Conv3d:
    """Bias-free 3D convolution with torch-style integer padding and the
    JAX package's kaiming-normal fan-in init (its ``conv``,
    ``use_bias=False``)."""
    c = nn.Conv3d(in_channels, out_channels, kernel, stride=stride,
                  padding=padding, bias=False)
    kaiming_normal_(c.weight, in_channels * kernel ** 3)
    return c


def dense(in_features: int, out_features: int) -> nn.Linear:
    """Linear layer with flax ``Dense``'s init: lecun-normal kernel, zero
    bias."""
    d = nn.Linear(in_features, out_features)
    lecun_normal_(d.weight, in_features)
    nn.init.zeros_(d.bias)
    return d


def max_pool(x, window: int, stride: int, padding: int):
    """Max pool with symmetric integer padding (padding counts as -inf)."""
    return F.max_pool3d(x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Average pool, VALID padding."""
    return F.avg_pool3d(x, window, stride)


def global_avg_pool(x):
    """(N, C, D, H, W) -> (N, C)."""
    return x.mean(dim=(2, 3, 4))
