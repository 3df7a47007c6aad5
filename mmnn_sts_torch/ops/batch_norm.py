"""Train-mode BatchNorm on the card: four hand-written CUDA kernels.

``kernels/csrc/batch_norm.cu`` computes a BatchNorm of channels-last
activations in four launches of one pass each: the batch statistics with
the running update and the fold (``bn_stats_kernel``), the normalise with
the masked rows zeroed and the ReLU after it (``bn_normalize_kernel``), the
backward's per-channel sums with dweight and dbias (``bn_backward_sums_kernel``)
and dx (``bn_backward_dx_kernel``). The plain PyTorch version is
``models/common.BatchNorm`` and ``compute_batch_stats`` themselves: the
kernels compute its formula (see the source's header), and differ from it
only in the order of the float32 sums. They replace no TPU kernel (the JAX
package leaves BatchNorm to XLA); they exist because PyTorch runs each
BatchNorm as some forty small kernels, and the DenseNet superstep is bound
by that count.

* ``batch_norm``: a BatchNorm layer's forward, in train mode through
  ``BatchNormFunction`` (stats + normalise; its backward sums + dx), in
  eval mode without autograd the normalise alone on the running
  statistics;
* ``bottleneck_fold``: the fused bottleneck's train-mode statistics,
  folded into the ``a``, ``b`` that ``ops/fused_dense.FusedBnReluMatmul``
  takes (``BottleneckStats``: stats forward, dx backward).

Both take the plain path as a callable, ``plain``, and run it where the
kernels do not apply: ``takes_kernels`` is the rule, a float32 or bfloat16
activation in the channels-last memory format of its rank (or a
contiguous (N, C)), with no mesh shard active (whose statistics sum over
ranks) and either train mode or no autograd. Other calls on a CUDA tensor
(a mesh's ranks, eval mode with gradients as Grad-CAM takes them) run
``plain`` and add one to ``plain_calls``; CPU tensors run it and count
nothing. Inside ``with plain_only():`` every call runs ``plain`` (the
kernels' witness in the checks). ``launches`` counts the kernels' host
launches (a CUDA graph replay launches none); both counters also go to
``utils/tracing.count`` as ``batch_norm.launches`` and
``batch_norm.plain_calls``.

Sums across CTAs meet in the last CTA of a column, found with a ticket
counter in the library (``bn_tickets``) that it resets itself. A stream
gets a row of tickets of its own (``_slot``), so a captured graph replays
with the row of its capture stream: two launches that share a stream's
row must not run at once (two graphs captured on one stream replayed
side by side on two), and a process that launches on more than
``MAX_SLOTS`` streams of a card raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..kernels import build
from ..parallel import mesh
from ..utils import tracing

BLOCK = 256  # threads of a CTA at most
LANES = 8  # channel lanes of a CTA: one row segment of 8 x 16 bytes
MIN_PASSES = 4  # row passes a thread walks at the least
# row passes under which a reducing kernel's column is one CTA, which then
# needs no sum across CTAs
SINGLE_PASSES = 16
WAVES = {True: 2, False: 4}  # CTAs per SM: reducing kernels, the others
MAX_COLUMNS = 256  # column blocks of a launch (batch_norm.cu)
MAX_SLOTS = 64  # ticket rows (batch_norm.cu)
STATS_ROWS = 6  # mean, var, rstd, a, b, fvar; then n and any_valid
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
plain_calls = 0
_plain_only = False


def count_plain():
    """Note one CUDA BatchNorm call that took the plain path."""
    global plain_calls
    plain_calls += 1
    tracing.count("batch_norm.plain_calls")


@contextlib.contextmanager
def plain_only():
    """Every BatchNorm call inside takes the plain path (``takes_kernels``
    is false), as a mesh's ranks do."""
    global _plain_only
    before, _plain_only = _plain_only, True
    try:
        yield
    finally:
        _plain_only = before


def _runs_kernels(x, training: bool, dtype=None) -> bool:
    """``takes_kernels`` for a CUDA x; a CUDA call that it refuses counts
    in ``plain_calls``, a CPU call nowhere."""
    if not x.is_cuda:
        return False
    if takes_kernels(x, training, dtype):
        return True
    count_plain()
    return False


def _memory_format(x):
    return {5: torch.channels_last_3d, 4: torch.channels_last}.get(
        x.dim(), torch.contiguous_format)


def takes_kernels(x, training: bool, dtype=None) -> bool:
    """Whether a BatchNorm call on ``x`` (output dtype ``dtype``, x's by
    default) runs the kernels, x's device aside: a float32 or bfloat16
    activation of 2, 4 or 5 dims in its rank's channels-last format
    (contiguous for 2), the output in x's dtype, no mesh shard active, and
    train mode or no autograd (eval mode with gradients keeps the plain
    path), outside ``plain_only``."""
    return (not _plain_only and x.dtype in _DTYPES
            and (dtype is None or dtype == x.dtype) and x.dim() in (2, 4, 5) and x.numel() > 0
            and x.is_contiguous(memory_format=_memory_format(x))
            and -(-x.shape[1] // (vec_width(x.shape[1], x) * LANES))
            <= MAX_COLUMNS
            and mesh.active_shard() is None
            and (training or not torch.is_grad_enabled()))


def vec_width(channels: int, *tensors) -> int:
    """Channels a thread reads at once: 8 or 4 where they divide C and
    every tensor's start is aligned for them (16 bytes at most), else 1."""
    for vec in (8, 4):
        if channels % vec == 0 and all(
                t.data_ptr() % min(16, vec * t.element_size()) == 0
                for t in tensors):
            return vec
    return 1


@functools.cache
def plan(rows: int, channels: int, vec: int, sms: int,
         reduce: bool) -> tuple[int, int, int, int, int]:
    """``(grid_x, grid_y, lanes, row_lanes, rows_per_cta)`` of a launch
    over (rows, C): up to ``LANES`` threads across a row's channel groups
    of ``vec`` and a power of two of row lanes under them (``BLOCK``
    threads at most); a column block a ``lanes * vec`` channels; and
    row blocks for about ``WAVES[reduce]`` CTAs an SM, each thread walking
    ``MIN_PASSES`` row passes or more. The reducing kernels take fewer
    CTAs, since their last CTA sums one partial each, and one a column
    up to ``SINGLE_PASSES`` row passes."""
    groups = channels // vec
    lanes = min(groups, LANES)
    row_lanes = 1 << ((BLOCK // lanes).bit_length() - 1)
    columns = -(-groups // lanes)
    passes = -(-rows // row_lanes)
    ctas = max(1, min(-(-WAVES[reduce] * sms // columns),
                      -(-passes // MIN_PASSES)))
    if reduce and passes <= SINGLE_PASSES:
        ctas = 1
    rows_per_cta = -(-passes // ctas) * row_lanes
    return -(-rows // rows_per_cta), columns, lanes, row_lanes, rows_per_cta


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_slots: dict[int, int] = {}


def _slot(stream: int) -> int:
    """The ticket row of a CUDA stream: one per stream in order of first
    use (a launch's tickets are only touched by launches on its stream).
    Raises on the stream after the ``MAX_SLOTS``-th, which would share
    a row."""
    if stream not in _slots:
        if len(_slots) == MAX_SLOTS:
            raise RuntimeError(f"batch_norm: launches on more than "
                               f"{MAX_SLOTS} CUDA streams, the ticket rows "
                               f"of batch_norm.cu")
        _slots[stream] = len(_slots)
    return _slots[stream]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "bn_stats_launch": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _F,
                        _F, _F, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "bn_normalize_launch": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                            _F, _I] + [_I] * 7 + [_P],
    "bn_backward_sums_launch": [_P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P] + [_I] * 8 + [_P],
    "bn_backward_dx_launch": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P,
                              _P, _P, _P, _P] + [_I] * 7 + [_P],
}


@functools.cache
def _launcher(name: str):
    fn = getattr(build.load("batch_norm"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, x, args, vec: int, reduce: bool):
    """Launch ``name`` over x's (rows, C) on the current stream with
    ``args`` before the geometry; the reducing kernels also get the
    stream's ticket row. Raises on a refused launch."""
    rows, channels = x.numel() // x.shape[1], x.shape[1]
    geometry = plan(rows, channels, vec, _sm_count(x.device.index), reduce)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = [vec, *geometry] + ([_slot(stream)] if reduce else [])
    rc = _launcher(name)(*args, *tail, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"batch_norm: {name} {tuple(x.shape)} "
                           f"{geometry} failed with CUDA error {rc}")
    global launches
    launches += 1
    tracing.count("batch_norm.launches")


def _rows(x):
    """(rows, C, rows of a sample)"""
    return x.numel() // x.shape[1], x.shape[1], x[0, 0].numel()


def _mask(mask):
    return None if mask is None else mask.float().contiguous()


def _partial(x, vec: int):
    """The per-CTA sums of a reducing launch over x with ``vec``."""
    rows, channels = x.numel() // x.shape[1], x.shape[1]
    grid_x = plan(rows, channels, vec, _sm_count(x.device.index), True)[0]
    return torch.empty((grid_x, 2, channels), dtype=torch.float32,
                       device=x.device)


def _stats(x, weight, bias, running_mean, running_var, mask, update: bool,
           eps: float, momentum: float, fold: bool):
    """Launch the statistics kernel: returns the stats buffer (and the
    folded ``a``, ``b`` with ``fold``)."""
    rows, channels, vox = _rows(x)
    vec = vec_width(channels, x)
    partial = _partial(x, vec)
    stats = torch.empty(STATS_ROWS * channels + 2, dtype=torch.float32,
                        device=x.device)
    a = b = None
    if fold:
        a, b = (torch.empty(channels, dtype=torch.float32, device=x.device)
                for _ in range(2))
    _launch("bn_stats_launch", x, [
        x.data_ptr(), _DTYPES[x.dtype], _ptr(mask), rows, channels, vox,
        weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), int(update), eps, momentum, 1.0 - momentum,
        rows / max(rows - 1, 1), partial.data_ptr(), stats.data_ptr(),
        _ptr(a), _ptr(b)], vec, True)
    return stats, a, b


def _normalize(x, out, mask, stats, weight, bias, running_mean, running_var,
               eps: float, relu: bool):
    rows, channels, vox = _rows(x)
    _launch("bn_normalize_launch", x, [
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], _ptr(mask), rows,
        channels, vox, _ptr(stats), weight.data_ptr(), bias.data_ptr(),
        running_mean.data_ptr(), running_var.data_ptr(), eps, int(relu)],
        vec_width(channels, x, out), False)


def _dx(g, y, x, mask, stats, coef=None, da=None, db=None, scale=None,
        dscale=None):
    rows, channels, vox = _rows(x)
    dx = torch.empty_like(x)
    _launch("bn_backward_dx_launch", x, [
        _ptr(g), _ptr(y), x.data_ptr(), dx.data_ptr(), _DTYPES[x.dtype],
        _ptr(mask), rows, channels, vox, stats.data_ptr(), _ptr(coef),
        _ptr(da), _ptr(db), _ptr(scale), _ptr(dscale)],
        vec_width(channels, *(t for t in (g, y, x, dx) if t is not None)),
        False)
    return dx


class BatchNormFunction(torch.autograd.Function):
    """A train-mode BatchNorm layer on the kernels: forward ``bn_stats``
    (with the running update where ``update``) and ``bn_normalize``;
    backward ``bn_backward_sums`` and ``bn_backward_dx``. x (N, C, ...)
    channels-last, mask (N,) 0/1 or None, output in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mask,
                relu: bool, update: bool, eps: float, momentum: float):
        mask = _mask(mask)
        stats, _, _ = _stats(x, weight, bias, running_mean, running_var,
                             mask, update, eps, momentum, fold=False)
        y = torch.empty_like(x)
        _normalize(x, y, mask, stats, weight, bias, running_mean,
                   running_var, eps, relu)
        ctx.save_for_backward(x, y if relu else None, mask, stats, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, mask, stats, weight = ctx.saved_tensors
        fmt = _memory_format(x)
        g = g.contiguous(memory_format=fmt)
        if vec_width(x.shape[1], g) < vec_width(x.shape[1], x):
            g = g.clone(memory_format=fmt)  # a view's misaligned start
        rows, channels, vox = _rows(x)
        tensors = [t for t in (g, y, x) if t is not None]
        vec = vec_width(channels, *tensors)
        partial = _partial(x, vec)
        coef = torch.empty((2, channels), dtype=torch.float32,
                           device=x.device)
        dweight, dbias = (torch.empty(channels, dtype=torch.float32,
                                      device=x.device) for _ in range(2))
        _launch("bn_backward_sums_launch", x, [
            g.data_ptr(), _ptr(y), x.data_ptr(), _DTYPES[x.dtype],
            _ptr(mask), rows, channels, vox, stats.data_ptr(),
            weight.data_ptr(), partial.data_ptr(), coef.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr()], vec, True)
        dx = (_dx(g, y, x, mask, stats, coef=coef)
              if ctx.needs_input_grad[0] else None)
        return dx, dweight, dbias, None, None, None, None, None, None, None


class BottleneckStats(torch.autograd.Function):
    """The fused bottleneck's train-mode statistics of x, folded: ``a =
    scale * rstd``, ``b = bias - mean * a`` (float32, (C,)), with the
    running update where ``update``. Backward: ``(da, db)`` to dx (one
    ``bn_backward_dx`` launch, which also writes dscale), dscale and
    dbias = db."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, mask,
                update: bool, eps: float, momentum: float):
        mask = _mask(mask)
        stats, a, b = _stats(x, scale, bias, running_mean, running_var,
                             mask, update, eps, momentum, fold=True)
        ctx.save_for_backward(x, mask, stats, scale)
        return a, b

    @staticmethod
    def backward(ctx, da, db):
        x, mask, stats, scale = ctx.saved_tensors
        dscale = torch.empty_like(scale)
        dx = _dx(None, None, x, mask, stats, da=da.contiguous(),
                 db=db.contiguous(), scale=scale, dscale=dscale)
        return dx, dscale, db, None, None, None, None, None, None


def batch_norm(x, weight, bias, running_mean, running_var, mask=None, *,
               plain, training: bool, relu: bool = False, dtype=None,
               update: bool = True, eps: float, momentum: float):
    """A BatchNorm layer's output (in ``dtype``, x's where None) on the
    kernels where ``takes_kernels`` admits a CUDA x, else ``plain()``:
    train mode through ``BatchNormFunction``, eval mode (no autograd) the
    normalise alone on the running statistics, neither masking rows.
    ``relu`` applies the ReLU after it."""
    if not _runs_kernels(x, training, dtype):
        return plain()
    if training:
        return BatchNormFunction.apply(x, weight, bias, running_mean,
                                       running_var, mask, relu, update, eps,
                                       momentum)
    y = torch.empty_like(x)
    _normalize(x, y, None, None, weight, bias, running_mean, running_var,
               eps, relu)
    return y


def bottleneck_fold(x, scale, bias, running_mean, running_var, mask=None, *,
                    plain, update: bool = True, eps: float, momentum: float):
    """``(a, b)`` of the fused bottleneck in train mode: on the kernels
    (``BottleneckStats``) where ``takes_kernels`` admits a CUDA x, else
    ``plain()``."""
    if not _runs_kernels(x, True):
        return plain()
    return BottleneckStats.apply(x, scale, bias, running_mean, running_var,
                                 mask, update, eps, momentum)
