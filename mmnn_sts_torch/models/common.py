"""Shared model building blocks (counterpart of the JAX
package's models/common.py).

Image activations are ``(N, C, D, H, W)`` tensors in
``torch.channels_last_3d`` memory format (``spatial_dims: 3``) or
``(N, C, H, W)`` in ``torch.channels_last`` (``spatial_dims: 2``): the same
bytes as the JAX package's ``(N, *spatial, C)`` layout, so the DenseNet
bottleneck sees a free ``(voxels, channels)`` view. Features are dim 1
everywhere, so one statistics function serves the image and the clinical
(N, C) BatchNorms. The layers take their number of spatial dimensions as
the JAX package's do (common.py:177-243): ``conv(..., spatial_dims=)``
builds a 2D or 3D convolution, and the pools and the channel dropout
follow the input's rank.

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
import math
import threading
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import mesh

CHANNELS_LAST = torch.channels_last_3d
BN_EPS = 1e-5
# running-stat decay (torch momentum 0.1), the JAX package's BN_MOMENTUM
BN_MOMENTUM = 0.9
# stddev of a standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so that the truncated draw keeps variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x in the channels-last memory format of its rank (4 or 5 dims)."""
    fmt = CHANNELS_LAST if x.dim() == 5 else torch.channels_last
    return x.contiguous(memory_format=fmt)


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

    Where x is one rank's rows of a batch sharded over the ``data`` axis
    (``parallel/mesh.sharded``), the moments go over the ranks in one
    all-reduce, so the statistics are the whole batch's: without a mask
    the ranks' ``(E[x], E[x^2])`` are averaged (every rank holds as many
    rows, and one rank's average is its own bits), with one the sums
    ``(sum x, sum x^2, n_valid)`` are added."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    zero = xf.new_zeros(())
    shard = mesh.active_shard()
    if mask is None:
        n = x.numel() // x.shape[1]
        mean, mean_sq = xf.mean(dims), xf.square().mean(dims)
        if shard is not None:
            mean, mean_sq = (shard.all_reduce(torch.cat([mean, mean_sq]))
                             / shard.size).split(len(mean))
            n *= shard.size
        var = torch.maximum(mean_sq - mean.square(), zero)
        return mean, var, var * (n / max(n - 1, 1)), None
    mf = mask.float().view((-1,) + (1,) * (x.dim() - 1))
    n_valid = mf.sum() * (x[0, 0].numel())
    s1, s2 = (xf * mf).sum(dims), (xf.square() * mf).sum(dims)
    if shard is not None:
        s1, s2, n_valid = shard.all_reduce(
            torch.cat([s1, s2, n_valid.view(1)])).split([len(s1)] * 2 + [1])
        n_valid = n_valid[0]
    denom = torch.clamp(n_valid, min=1.0)
    any_valid = n_valid > 0
    mean = s1 / denom
    var = torch.maximum(s2 / denom - mean.square(), zero)
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
    """``torch.rand(shape)`` from ``generator``: the dropout masks' draws
    (where the batch is one rank's rows of a sharded one, that rank's rows
    of the whole batch's draws). Inside ``remat_call``'s recompute the
    forward's draws come back in order instead, and nothing is drawn."""
    replay = getattr(_draws, "replay", None)
    if replay is not None:
        return next(replay)
    shard = mesh.active_shard()
    if shard is None:
        u = torch.rand(shape, generator=generator, device=device)
    else:  # the whole batch's draws, as every rank draws them; its rows
        u = shard.rows(torch.rand((shape[0] * shard.size,) + tuple(shape[1:]),
                                  generator=generator, device=device))
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


class _ComputeDtype:
    """A convolution computing in ``compute_dtype`` where it is set (flax
    ``Conv`` with ``dtype``)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view((-1,) + (1,) * (y.dim() - 2))


class Conv2d(_ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""


class Conv3d(_ComputeDtype, nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype``."""


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


def _ntuple(v, n: int) -> tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def conv(in_channels: int, out_channels: int, kernel: int | Sequence[int],
         stride: int | Sequence[int] = 1,
         padding: int | Sequence[int] | str = 0,
         dtype: torch.dtype | None = None, use_bias: bool = False,
         fan_out_init: bool = False, spatial_dims: int = 3):
    """An N-D convolution (``spatial_dims`` 2 or 3) as the JAX package's
    ``conv`` (common.py:215-243), computing in ``dtype``: ``kernel``,
    ``stride`` and ``padding`` per axis or one for all; an integer padding
    pads both sides (torch-style), and JAX's ``"VALID"`` (none) and
    ``"SAME"`` are taken where SAME pads both sides alike (a 1-wide kernel,
    or stride 1 and an odd kernel: every use in the models). ``use_bias``
    adds a zero-initialised bias. The kernel init is kaiming-normal over
    the fan-in, or over the fan-out with ``fan_out_init``
    (``kaiming_normal_out``, common.py:27)."""
    kernel = _ntuple(kernel, spatial_dims)
    stride = _ntuple(stride, spatial_dims)
    if padding == "VALID":
        padding = 0
    elif padding == "SAME":
        if not all(k == 1 or (s == 1 and k % 2)
                   for k, s in zip(kernel, stride)):
            raise ValueError(f"SAME padding of kernel {kernel} at stride "
                             f"{stride} pads one side more than the other")
        padding = tuple((k - 1) // 2 for k in kernel)
    cls = {2: Conv2d, 3: Conv3d}[spatial_dims]
    c = cls(in_channels, out_channels, kernel, stride=stride,
            padding=padding, bias=use_bias)
    fan = out_channels if fan_out_init else in_channels
    kaiming_normal_(c.weight, fan * math.prod(kernel))
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


_POOL_FN = {"max": {2: F.max_pool2d, 3: F.max_pool3d},
            "avg": {2: F.avg_pool2d, 3: F.avg_pool3d}}


class _MaxPool(torch.autograd.Function):
    """``F.max_pool2d`` / ``max_pool3d`` whose backward adds each input's
    gradient in a fixed order: torch's CPU order (the outputs in row-major
    order, each add rounded to the gradient's dtype), as one strided add
    into a padded buffer per offset in the window, the last offset first.
    The card's own backward adds with atomics, so two runs of one training
    step would differ in the last bits of the stem's gradients."""

    @staticmethod
    def forward(ctx, x, window, stride, padding):
        pool = _POOL_FN["max"][x.dim() - 2]
        out, idx = pool(x, window, stride, padding, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.geometry = (x.shape, window, stride, padding)
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, window, stride, padding = ctx.geometry
        (n, c), spatial = shape[:2], shape[2:]
        nd = len(spatial)
        outs = g.shape[2:]
        # each output's window corner as a flat index into the input plane
        # (row-major over the spatial axes), and its argmax as the offset
        # from that corner
        corner = torch.zeros((), dtype=torch.int64, device=g.device)
        for axis, (o, size) in enumerate(zip(outs, spatial)):
            start = torch.arange(o, device=g.device) * stride - padding
            corner = corner.unsqueeze(-1) * size + start.view(
                (1,) * axis + (-1,))
        offset = idx - corner
        fmt = (torch.contiguous_format if g.is_contiguous()
               else CHANNELS_LAST if nd == 3 else torch.channels_last)
        acc = torch.zeros((n, c) + tuple(s + 2 * padding for s in spatial),
                          dtype=g.dtype, device=g.device
                          ).contiguous(memory_format=fmt)
        span = [stride * (o - 1) + 1 for o in outs]
        # an input's windows in row-major order are its offsets in reverse
        for taps in itertools.product(range(window - 1, -1, -1), repeat=nd):
            flat = 0
            for t, size in zip(taps, spatial):
                flat = flat * size + t
            region = tuple(slice(t, t + sp, stride)
                           for t, sp in zip(taps, span))
            acc[(slice(None), slice(None)) + region].add_(
                g.masked_fill(offset != flat, 0))
        grad = acc[(slice(None), slice(None)) + tuple(
            slice(padding, padding + s) for s in spatial)]
        return grad.contiguous(memory_format=fmt), None, None, None


def max_pool(x, window: int, stride: int, padding: int):
    """Max pool over x's spatial dims (2 or 3) with symmetric integer
    padding (padding counts as -inf); where a gradient is taken, its
    backward is deterministic (``_MaxPool``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, window, stride, padding)
    return _POOL_FN["max"][x.dim() - 2](x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Average pool over x's spatial dims, VALID padding. Below float32 it
    is flax's ``avg_pool`` (common.py:185-188): a running sum over the
    window in row-major order, each addition rounded to x's dtype, then
    divided by the window's size (``F.avg_pool3d`` sums in float32)."""
    nd = x.dim() - 2
    if x.dtype == torch.float32:
        return _POOL_FN["avg"][nd](x, window, stride)
    out = [(n - window) // stride + 1 for n in x.shape[2:]]
    total = None
    for taps in itertools.product(range(window), repeat=nd):
        piece = x[(slice(None), slice(None)) + tuple(
            slice(t, t + stride * (o - 1) + 1, stride)
            for t, o in zip(taps, out))]
        total = piece if total is None else total + piece
    return total / window ** nd


def global_avg_pool(x):
    """(N, C, *spatial) -> (N, C)."""
    return x.mean(dim=tuple(range(2, x.dim())))
