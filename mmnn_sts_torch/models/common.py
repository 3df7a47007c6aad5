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

Under a step's ``space`` shard (``parallel/mesh.sharded``) a 5-D
activation is this rank's block of depth planes: the convolutions and
pools first gather the planes their block of the output reads
(``SpaceShard.window``), BatchNorm and the global pool sum over the
ranks, and dropout keeps the rank's planes of the whole batch's draws.
A 2D model is run replicated over ``space`` (``parallel/mesh.settle_space``).

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

from ..ops import batch_norm
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

    Where x is one rank's block of a batch sharded over the mesh
    (``parallel/mesh.sharded``: rows over ``data``, depth planes over
    ``space``), the moments go over the step's ranks in one all-reduce, so
    the statistics are the whole batch's: with rows alone and no mask the
    ranks' ``(E[x], E[x^2])`` are averaged (every rank holds as many rows,
    and one rank's average is its own bits); under ``space`` (whose blocks
    of planes may differ, or be empty) and with a mask the sums ``(sum x,
    sum x^2, n)`` are added, each rank weighing by its valid voxels. A
    tensor that the ``space`` ranks hold whole (the clinical rows) goes
    over the ``data`` ranks alone (``Shard.holding``)."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    zero = xf.new_zeros(())
    shard = mesh.active_shard()
    if shard is not None:
        shard = shard.holding(x)
    if mask is None and shard is not None and shard.space is not None:
        s1, s2 = xf.sum(dims), xf.square().sum(dims)
        n = xf.new_full((1,), x.numel() // x.shape[1])
        s1, s2, n = shard.all_reduce(torch.cat([s1, s2, n])).split(
            [len(s1)] * 2 + [1])
        mean = s1 / torch.clamp(n, min=1.0)
        var = torch.maximum(s2 / torch.clamp(n, min=1.0) - mean.square(),
                            zero)
        return mean, var, var * (n / torch.clamp(n - 1.0, min=1.0)), None
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


def recomputing() -> bool:
    """Whether this thread runs a ``remat_call`` recompute."""
    return getattr(_recomputing, "on", False)


def dropout_uniforms(shape, generator, device,
                     planes: torch.Tensor | None = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``: the dropout masks' draws.
    Where the batch is one rank's block of a sharded one, that rank's
    block of the whole batch's draws, as every rank draws them: its rows,
    and its depth planes where ``planes`` (the activation the draws mask,
    (N, C, D', H, W)) is depth-sharded. Inside ``remat_call``'s recompute
    the forward's draws come back in order instead, and nothing is
    drawn."""
    replay = getattr(_draws, "replay", None)
    if replay is not None:
        return next(replay)
    shard = mesh.active_shard()
    if shard is None:
        u = torch.rand(shape, generator=generator, device=device)
    else:
        whole = [shape[0] * shard.row_ranks] + list(shape[1:])
        space = shard.space if planes is not None else None
        if space is not None:
            whole[2] = space.depth_of(planes)
        u = shard.rows(torch.rand(whole, generator=generator, device=device))
        if space is not None:
            u = space.keep(u, 2)
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
    if recomputing():
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
    (common.py:137, 153). Parameters and buffers carry torch's names.

    On the card a call that ``ops/batch_norm.takes_kernels`` admits (a
    channels-last activation, no mesh shard, train mode or no autograd)
    runs the hand-written kernels of ``ops/batch_norm`` instead of the
    plain code (``_plain``), which stays the CPU's path and every other
    call's."""

    def __init__(self, num_features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, sample_mask=None, relu: bool = False):
        """``relu`` applies the ReLU to the output (``F.relu``), fused into
        the kernels' normalise on the card."""
        return batch_norm.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            sample_mask, plain=lambda: self._plain(x, sample_mask, relu),
            training=self.training, relu=relu, dtype=self.compute_dtype,
            update=not recomputing(), eps=BN_EPS, momentum=BN_MOMENTUM)

    def _plain(self, x, sample_mask, relu: bool):
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
        out = out.to(self.compute_dtype or x.dtype)
        return F.relu(out) if relu else out


class LayerNorm(nn.Module):
    """LayerNorm over the last dim (eps 1e-5, torch's ``nn.LayerNorm``),
    computed in float32 whatever x's dtype; the output is in ``dtype``, or
    in x's where that is None. ``affine=False`` has no parameters (MONAI's
    ``F.layer_norm`` on the Swin encoder's output)."""

    def __init__(self, num_features: int, dtype: torch.dtype | None = None,
                 affine: bool = True):
        super().__init__()
        self.compute_dtype = dtype
        self.shape = (num_features,)
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        y = F.layer_norm(x.float(), self.shape, self.weight, self.bias, 1e-5)
        return y.to(self.compute_dtype or x.dtype)


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
        if self.channels:
            keep = dropout_uniforms(x.shape[:2] + (1,) * (x.dim() - 2),
                                    generator, x.device)
        else:
            keep = dropout_uniforms(x.shape, generator, x.device,
                                    planes=x if x.dim() == 5 else None)
        keep = keep < 1.0 - self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


def _nothing_out(shape, *inputs):
    """An empty output of ``shape`` (a rank whose block of planes is empty)
    that still reaches ``inputs`` in the autograd graph, so that this
    rank's backward runs the same collectives as the others'."""
    zero = sum(t.sum() for t in inputs if t is not None) * 0
    return inputs[0].new_zeros(shape) + zero.to(inputs[0].dtype)


class _ComputeDtype:
    """A convolution computing in ``compute_dtype`` where it is set (flax
    ``Conv`` with ``dtype``). On a depth-sharded activation
    (``parallel/mesh.sharded`` with a ``space`` shard) it first gathers the
    planes its block of the output reads from the neighbours, zero at the
    volume's edges (``SpaceShard.window``), then convolves with no depth
    padding."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        space = mesh.active_space()
        if space is not None and x.dim() == 5:
            return self._sharded_forward(x, space)
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view((-1,) + (1,) * (y.dim() - 2))

    def _sharded_forward(self, x, space):
        xw, depth, planes = space.window(x, self.kernel_size[0],
                                         self.stride[0], self.padding[0])
        dt = self.compute_dtype
        w = self.weight if dt is None else self.weight.to(dt)
        xw = xw if dt is None else xw.to(dt)
        bias = self.bias if dt is None else None
        if planes == 0:
            y = _nothing_out((x.shape[0], self.out_channels, 0) + tuple(
                mesh.out_depth(n, k, s, p) for n, k, s, p in zip(
                    x.shape[3:], self.kernel_size[1:], self.stride[1:],
                    self.padding[1:])), xw, w, bias)
        else:
            y = F.conv3d(xw, w, bias, self.stride, (0,) + tuple(
                self.padding[1:]), self.dilation, self.groups)
        if dt is not None and self.bias is not None:
            y = y + self.bias.to(dt).view(-1, 1, 1, 1)
        return space.register(y, depth)


class Conv2d(_ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""


class Conv3d(_ComputeDtype, nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype``."""


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where it is set (flax
    ``Dense`` with ``dtype``: the product rounded to it, then the bias,
    where there is one, added in it)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


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
        ctx.geometry = (x.shape, window, stride,
                        _ntuple(padding, x.dim() - 2))
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, window, stride, pads = ctx.geometry
        (n, c), spatial = shape[:2], shape[2:]
        nd = len(spatial)
        outs = g.shape[2:]
        # each output's window corner as a flat index into the input plane
        # (row-major over the spatial axes), and its argmax as the offset
        # from that corner
        corner = torch.zeros((), dtype=torch.int64, device=g.device)
        for axis, (o, size, pad) in enumerate(zip(outs, spatial, pads)):
            start = torch.arange(o, device=g.device) * stride - pad
            corner = corner.unsqueeze(-1) * size + start.view(
                (1,) * axis + (-1,))
        offset = idx - corner
        fmt = (torch.contiguous_format if g.is_contiguous()
               else CHANNELS_LAST if nd == 3 else torch.channels_last)
        acc = torch.zeros((n, c) + tuple(s + 2 * p for s, p in zip(
            spatial, pads)), dtype=g.dtype, device=g.device
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
            slice(p, p + s) for s, p in zip(spatial, pads))]
        return grad.contiguous(memory_format=fmt), None, None, None


def max_pool(x, window: int, stride: int, padding: int):
    """Max pool over x's spatial dims (2 or 3) with symmetric integer
    padding (padding counts as -inf); where a gradient is taken, its
    backward is deterministic (``_MaxPool``). A depth-sharded activation
    first gathers its window's planes, -inf at the volume's edges."""
    space = mesh.active_space()
    if space is not None and x.dim() == 5:
        xw, depth, planes = space.window(x, window, stride, padding,
                                         fill=float("-inf"))
        pads = (0, padding, padding)
        y = (_pooled_nothing(x, xw, window, stride, padding) if planes == 0
             else _max_pool(xw, window, stride, pads))
        return space.register(y, depth)
    return _max_pool(x, window, stride, padding)


def _pooled_nothing(x, xw, window: int, stride: int, pad: int):
    """A pool's empty block of planes (``_nothing_out``)."""
    return _nothing_out((x.shape[0], x.shape[1], 0) + tuple(
        mesh.out_depth(n, window, stride, pad) for n in x.shape[3:]), xw)


def _max_pool(x, window, stride, padding):
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, window, stride, padding)
    return _POOL_FN["max"][x.dim() - 2](x, window, stride, padding)


def avg_pool(x, window: int, stride: int):
    """Average pool over x's spatial dims, VALID padding. Below float32 it
    is flax's ``avg_pool`` (common.py:185-188): a running sum over the
    window in row-major order, each addition rounded to x's dtype, then
    divided by the window's size (``F.avg_pool3d`` sums in float32). A
    depth-sharded activation first gathers its window's planes."""
    space = mesh.active_space()
    if space is not None and x.dim() == 5:
        xw, depth, planes = space.window(x, window, stride, 0)
        y = (_pooled_nothing(x, xw, window, stride, 0) if planes == 0
             else _avg_pool(xw, window, stride))
        return space.register(y, depth)
    return _avg_pool(x, window, stride)


def _avg_pool(x, window: int, stride: int):
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
    """(N, C, *spatial) -> (N, C). A depth-sharded activation adds its
    block's sum over the ``space`` ranks and divides by the whole
    volume's voxels. Both paths accumulate in float32 and round to the
    activation's dtype once (``x.mean`` does so for bfloat16), so in
    bfloat16 they differ by the float32 summation order alone
    (tests/test_torch_space.py holds it within bfloat16's rounding)."""
    dims = tuple(range(2, x.dim()))
    space = mesh.active_space()
    if space is None or x.dim() != 5:
        return x.mean(dim=dims)
    voxels = space.depth_of(x) * x.shape[3] * x.shape[4]
    return (space.sum(x.float().sum(dim=dims)) / voxels).to(x.dtype)
