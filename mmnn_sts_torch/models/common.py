"""Shared model building blocks (counterpart of the JAX
package's models/common.py).

Image activations are ``(N, C, D, H, W)`` tensors in
``torch.channels_last_3d`` memory format: the same bytes as the JAX
package's ``(N, D, H, W, C)`` layout, so the DenseNet bottleneck sees a
free ``(voxels, channels)`` view. Features are dim 1 everywhere, so one
statistics function serves the image and the clinical (N, C) BatchNorms.

Train mode is ``module.training``, as in torch. A ``sample_mask`` (N,) of
0/1 marks the valid samples of a wrap-padded ragged batch; dropout draws
from the ``torch.Generator`` its caller passes. ``remat_call`` runs a
layer under ``torch.utils.checkpoint`` for ``TPU.remat``; its recompute
reuses the forward's dropout draws, so it also runs inside a CUDA graph.

``dtype`` is the compute dtype of ``TPU.compute_dtype``, as flax's ``dtype``
attribute: None (float32) casts nothing; ``torch.bfloat16`` casts a
layer's input and its float32 parameters at the call, and the layer returns
bfloat16. Parameters, BatchNorm statistics and the optimizer stay float32.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Sequence

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
    """The JAX package's convolution init (common.py:24): N(0, 2 / fan_in).
    Called with the fan-out, it is ``kaiming_normal_out`` (common.py:27)."""
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


# set (on the thread that runs it) while TPU.remat recomputes a layer's
# forward in the backward pass (``remat_call``): the recompute must not
# fold its batch statistics in a second time
_recomputing = threading.local()
# the uniform draws of the dropouts inside a remat region: recorded by the
# forward (``record``, a list), replayed by the recompute (``replay``, an
# iterator), per thread
_draws = threading.local()


def dropout_uniforms(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``: the dropout masks' draws.
    Inside ``remat_call``'s recompute the forward's draws come back in
    order instead, and nothing is drawn."""
    replay = getattr(_draws, "replay", None)
    if replay is not None:
        return next(replay)
    u = torch.rand(shape, generator=generator, device=device)
    record = getattr(_draws, "record", None)
    if record is not None:
        record.append(u)
    return u


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, unbiased,
                         any_valid=None):
    """In place: ``r = 0.9 r + 0.1 batch``, the running variance from the
    unbiased batch variance (torch's rule); a fully masked batch
    (``any_valid`` false) leaves both untouched, and so does a remat
    recompute."""
    if getattr(_recomputing, "on", False):
        return
    m = BN_MOMENTUM
    new_mean = m * running_mean + (1 - m) * mean
    new_var = m * running_var + (1 - m) * unbiased
    if any_valid is not None:
        new_mean = torch.where(any_valid, new_mean, running_mean)
        new_var = torch.where(any_valid, new_var, running_var)
    running_mean.copy_(new_mean)
    running_var.copy_(new_var)


def remat_call(fn, *args, generator: torch.Generator | None = None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (``TPU.remat``, the
    JAX package's ``nn.remat``): the backward pass recomputes ``fn``'s
    forward instead of keeping its activations. The recompute changes no
    number: its dropouts take the forward's uniform draws again (recorded
    by ``dropout_uniforms``, a (B, C) tensor a layer), so ``generator``
    ends where the unwrapped model leaves it, and it folds no batch
    statistics into the running ones a second time. ``generator`` is the
    one ``fn``'s dropouts draw from, if any; without it the recompute
    draws anew.

    The recompute touches no generator state, so it is the same inside a
    CUDA graph capture (``train/graphs.py``), where a generator's state can
    be neither read nor set: an offset drawn inside a capture is baked
    into the graph and no graph-safe state swap rewinds it. torch's own
    stash of the default generators is kept outside a capture only (the
    port's dropouts and augmentation draw from explicit generators)."""
    from torch.utils.checkpoint import checkpoint

    draws = [] if generator is not None else None

    @contextlib.contextmanager
    def forward():
        before = getattr(_draws, "record", None)
        _draws.record = draws
        try:
            yield
        finally:
            _draws.record = before

    @contextlib.contextmanager
    def recompute():
        before = (getattr(_recomputing, "on", False),
                  getattr(_draws, "replay", None))
        _recomputing.on = True
        _draws.replay = None if draws is None else iter(draws)
        try:
            yield
        finally:
            _recomputing.on, _draws.replay = before

    first = args[0]
    capturing = (isinstance(first, torch.Tensor) and first.is_cuda
                 and torch.cuda.is_current_stream_capturing())
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=not capturing,
                      context_fn=lambda: (forward(), recompute()))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with the JAX package's semantics
    (common.py:79-153): ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
    in float32; batch statistics in train mode (then the running-stat
    update, and masked rows of the output zeroed), running statistics in
    eval mode. The output is in ``dtype``, or in x's where that is None
    (common.py:137, 153). Parameters and buffers carry torch's names."""

    def __init__(self, num_features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
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
        return out.to(self.compute_dtype or x.dtype)


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
        keep = dropout_uniforms(shape, generator, x.device) < 1.0 - self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype`` where it is set (flax
    ``Conv`` with ``dtype``)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view(-1, 1, 1, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where it is set (flax
    ``Dense`` with ``dtype``: the product rounded to it, then the bias
    added in it)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _triple(v) -> tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def conv(in_channels: int, out_channels: int, kernel: int | Sequence[int],
         stride: int | Sequence[int] = 1,
         padding: int | Sequence[int] | str = 0,
         dtype: torch.dtype | None = None, use_bias: bool = False,
         fan_out_init: bool = False) -> Conv3d:
    """3D convolution as the JAX package's ``conv`` (common.py:215-243),
    computing in ``dtype``: ``kernel``, ``stride`` and ``padding`` per axis
    or one for all; an integer padding pads both sides (torch-style), and
    JAX's ``"VALID"`` (none) and ``"SAME"`` are taken where SAME pads both
    sides alike (a 1-wide kernel, or stride 1 and an odd kernel: every use
    in the models). ``use_bias`` adds a zero-initialised bias. The kernel
    init is kaiming-normal over the fan-in, or over the fan-out with
    ``fan_out_init`` (``kaiming_normal_out``, common.py:27)."""
    kernel, stride = _triple(kernel), _triple(stride)
    if padding == "VALID":
        padding = 0
    elif padding == "SAME":
        if not all(k == 1 or (s == 1 and k % 2)
                   for k, s in zip(kernel, stride)):
            raise ValueError(f"SAME padding of kernel {kernel} at stride "
                             f"{stride} pads one side more than the other")
        padding = tuple((k - 1) // 2 for k in kernel)
    c = Conv3d(in_channels, out_channels, kernel, stride=stride,
               padding=padding, bias=use_bias)
    fan = out_channels if fan_out_init else in_channels
    kaiming_normal_(c.weight, fan * kernel[0] * kernel[1] * kernel[2])
    if use_bias:
        nn.init.zeros_(c.bias)
    c.compute_dtype = dtype
    return c


def dense(in_features: int, out_features: int,
          dtype: torch.dtype | None = None,
          kernel_std: float | None = None) -> Linear:
    """Linear layer with flax ``Dense``'s init: lecun-normal kernel (or,
    with ``kernel_std``, ``initializers.normal(kernel_std)``), zero bias,
    computing in ``dtype``."""
    d = Linear(in_features, out_features)
    if kernel_std is None:
        lecun_normal_(d.weight, in_features)
    else:
        nn.init.normal_(d.weight, 0.0, kernel_std)
    nn.init.zeros_(d.bias)
    d.compute_dtype = dtype
    return d


class _MaxPool(torch.autograd.Function):
    """``F.max_pool3d`` whose backward adds each input's gradient in a
    fixed order: torch's CPU order (the outputs in row-major order, each
    add rounded to the gradient's dtype), as one strided add into a padded
    buffer per offset in the window, the last offset first. The card's own
    backward adds with atomics, so two runs of one training step would
    differ in the last bits of the stem's gradients."""

    @staticmethod
    def forward(ctx, x, window, stride, padding):
        out, idx = F.max_pool3d(x, window, stride, padding,
                                return_indices=True)
        ctx.save_for_backward(idx)
        ctx.geometry = (x.shape, window, stride, padding)
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        (n, c, d, h, w), window, stride, padding = ctx.geometry
        od, oh, ow = g.shape[2:]
        starts = [torch.arange(o, device=g.device) * stride - padding
                  for o in (od, oh, ow)]
        corner = ((starts[0].view(-1, 1, 1) * h + starts[1].view(1, -1, 1))
                  * w + starts[2].view(1, 1, -1))
        # each output's argmax as its offset a*h*w + b*w + c in the window
        offset = idx - corner
        fmt = (torch.contiguous_format if g.is_contiguous()
               else CHANNELS_LAST)
        acc = torch.zeros((n, c, d + 2 * padding, h + 2 * padding,
                           w + 2 * padding), dtype=g.dtype, device=g.device
                          ).contiguous(memory_format=fmt)
        span = [stride * (o - 1) + 1 for o in (od, oh, ow)]
        # an input's windows in row-major order are its offsets in reverse
        for a, b, k in itertools.product(range(window - 1, -1, -1),
                                         repeat=3):
            acc[:, :, a:a + span[0]:stride, b:b + span[1]:stride,
                k:k + span[2]:stride].add_(
                    g.masked_fill(offset != (a * h + b) * w + k, 0))
        grad = acc[:, :, padding:padding + d, padding:padding + h,
                   padding:padding + w]
        return grad.contiguous(memory_format=fmt), None, None, None


def max_pool(x, window: int, stride: int, padding: int):
    """Max pool with symmetric integer padding (padding counts as -inf);
    where a gradient is taken, its backward is deterministic
    (``_MaxPool``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, window, stride, padding)
    return F.max_pool3d(x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Average pool, VALID padding. Below float32 it is flax's
    ``avg_pool`` (common.py:185-188): a running sum over the window in
    row-major order, each addition rounded to x's dtype, then divided by
    the window's size (``F.avg_pool3d`` sums in float32)."""
    if x.dtype == torch.float32:
        return F.avg_pool3d(x, window, stride)
    out = [(n - window) // stride + 1 for n in x.shape[2:]]
    total = None
    for i, j, k in itertools.product(range(window), repeat=3):
        piece = x[:, :, i:i + stride * (out[0] - 1) + 1:stride,
                  j:j + stride * (out[1] - 1) + 1:stride,
                  k:k + stride * (out[2] - 1) + 1:stride]
        total = piece if total is None else total + piece
    return total / window ** 3


def global_avg_pool(x):
    """(N, C, D, H, W) -> (N, C)."""
    return x.mean(dim=(2, 3, 4))
