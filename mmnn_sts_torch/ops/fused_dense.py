"""Fused BatchNorm + ReLU + 1x1x1 convolution: the DenseNet bottleneck.

Counterpart of the JAX package's ops/pallas/fused_dense.py. A 1x1x1 convolution
over channels-last activations is a matmul over (voxels x channels), and the
BatchNorm + ReLU before it is an elementwise prologue on the same tile:

    out = relu(x * a + b) @ W,  a = scale / sqrt(var + eps),
                                b = bias - mean * a

On a CUDA tensor ``fused_bn_relu_matmul`` launches one of two hand-written
kernels, one per dtype, with the tile and K-split that ``launch_plan`` picks
for the shape and dtype: float32 takes
``kernels/csrc/fused_bn_relu_matmul.cu`` (FFMA on the CUDA cores), bfloat16
``kernels/csrc/fused_bn_relu_matmul_bf16.cu`` (wgmma on the tensor cores,
fed by TMA). On a CPU tensor it computes the plain
PyTorch version, ``fused_bn_relu_matmul_reference``. Nothing falls back: a
build or launch failure raises. The CPU tests hold the plain version against
the JAX package's Pallas kernel and the launch plans against their rules;
the ``cuda`` tests (tests/test_torch_fused_dense.py) and chip_smoke.py hold
each kernel against the plain version on the card.

``FusedBnReluMatmul`` is the op under autograd (the Pallas entry's custom
VJP): its forward is ``fused_bn_relu_matmul``, its backward the JAX
package's ``_bwd`` (fused_dense.py:93-106) in plain PyTorch, two products
and one elementwise and column-sum pass. ``bn_relu_conv1x1`` folds the
statistics into ``a`` and ``b`` under autograd, so in train mode the
gradient reaches x through the batch mean and variance as well.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

# the kernel source (kernels/csrc/<name>.cu) of each dtype
_SOURCES = {torch.float32: "fused_bn_relu_matmul",
            torch.bfloat16: "fused_bn_relu_matmul_bf16"}

# The float32 kernel's output tiles (BM, BN), largest first
# (fused_bn_relu_matmul.cu, ``dispatch``). A CTA has 128 threads, but 256 for
# 128 x 128, 64 for 32 x 32 and 32 for 16 x 32.
TILES = ((128, 128), (64, 128), (64, 64), (32, 64), (32, 32), (16, 32))
BK = 32  # depth of one chunk of K; a K-slice is whole chunks
MAX_SPLIT = 8  # CTAs in a cluster: the portable cluster size
RESIDENT_PER_SM = 4  # CTAs of 128 threads an SM runs at once

# The bfloat16 kernel's tiles (fused_bn_relu_matmul_bf16.cu), largest
# first: one warpgroup of 128 threads per 64 rows, so rows come in
# multiples of 64. Its chunk of K is 64 deep (128 bytes of bf16).
BF16_TILES = ((128, 128), (64, 128), (64, 64))
BF16_BK = 64
BF16_WAVE = 0.9  # a grid of this share of a wave of CTAs fills the card


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_ctas(m: int, n: int, bm: int, bn: int, split_k: int) -> int:
    """CTAs in the grid of a launch with tile (bm, bn) and split_k."""
    return _cdiv(m, bm) * _cdiv(n, bn) * split_k


def max_split(k: int, dtype=torch.float32) -> int:
    """The deepest K-split a launch may take. float32: 1 where K < 128, else
    as many slices as keep each at least two 32-deep chunks, up to
    MAX_SPLIT. bfloat16: one 64-deep chunk a slice at least, up to
    MAX_SPLIT (its plan takes two or more)."""
    if dtype == torch.bfloat16:
        return min(MAX_SPLIT, _cdiv(k, BF16_BK))
    return 1 if k < 4 * BK else min(MAX_SPLIT, k // (2 * BK))


def plan_tiles(dtype) -> tuple[tuple[int, int], ...]:
    """The output tiles the kernel of ``dtype`` takes, largest first."""
    return BF16_TILES if dtype == torch.bfloat16 else TILES


@functools.cache
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def launch_plan(m: int, k: int, n: int, sms: int,
                dtype=torch.float32) -> tuple[int, int, int]:
    """``(bm, bn, split_k)`` for an (M, K) x (K, N) call in ``dtype`` on a
    card of ``sms`` SMs: the output tile and the number of CTAs of a
    cluster that share it, each walking 1/split_k of K's chunks. bfloat16
    takes ``bf16_launch_plan``.

    float32 (``TILES``, 32-deep chunks): where a tile of at least 32 x 64
    (4 warps) fills the card (a wave of >= ``sms`` CTAs) without a split,
    the largest such tile: a finer tile walking all of K alone is slower
    than a split. Otherwise K is split as deep as ``max_split`` allows (at
    small M the chain of chunks one CTA walks, not the CTA count, sets the
    time), with the 32 x 64 tile, or the largest finer one that reaches a
    wave where 32 x 64 does not; and the split is cut back while the grid
    would exceed one round of resident CTAs. ``chip_smoke.py`` (its sweep
    phase) times these choices against every other plan."""
    if dtype == torch.bfloat16:
        return bf16_launch_plan(m, k, n, sms)
    split_tiles = TILES[TILES.index((32, 64)):]
    for bm, bn in TILES[:TILES.index((32, 64)) + 1]:
        if plan_ctas(m, n, bm, bn, 1) >= sms:
            return bm, bn, 1
    split = max_split(k)
    bm, bn = next((t for t in split_tiles
                   if plan_ctas(m, n, *t, split) >= sms), split_tiles[0])
    while split > 1 and plan_ctas(m, n, bm, bn, split) > RESIDENT_PER_SM * sms:
        split -= 1
    return bm, bn, split


def bf16_launch_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """The bfloat16 kernel's plan (``BF16_TILES``, 64-deep chunks): the
    largest tile whose grid comes within a tenth of a wave of ``sms`` CTAs
    unsplit (128 CTAs of 64 x 64 on 132 SMs beat any split); otherwise the
    64 x 64 tile with K split so that every rank walks two chunks or more
    and the grid stays within one wave, since at small M a launch's latency
    (the first load, the cluster's barriers), not its chunk chain, sets the
    time. ``chip_smoke.py``'s sweep times these choices against every plan
    ``max_split`` admits."""
    for bm, bn in BF16_TILES:
        if plan_ctas(m, n, bm, bn, 1) >= BF16_WAVE * sms:
            return bm, bn, 1
    bm, bn = BF16_TILES[-1]
    split = min(MAX_SPLIT, _cdiv(k, BF16_BK) // 2,
                sms // plan_ctas(m, n, bm, bn, 1))
    return bm, bn, max(1, split)


def fused_bn_relu_matmul_reference(x, a, b, w):
    """Plain version: ``relu(x.float() * a + b)`` rounded to w's dtype, then
    a float32-accumulated product, rounded to x's dtype
    (fused_dense.py:45-50). The ReLU is ``z * (z > 0)``: a NaN stays NaN,
    as in ``jnp.maximum(z, 0)``, and under autograd a NaN or zero z passes
    no gradient, as in the custom VJP's mask (torch.relu's gradient passes
    a NaN's)."""
    z = x.float() * a + b
    h = (z * (z > 0)).to(w.dtype)
    return torch.matmul(h.float(), w.float()).to(x.dtype)


def _check(x, a, b, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"fused_bn_relu_matmul: x {tuple(x.shape)} and w {tuple(w.shape)}"
            " must be (M, K) and (K, N)"
        )
    k = x.shape[1]
    if a.shape != (k,) or b.shape != (k,):
        raise ValueError(
            f"fused_bn_relu_matmul: a {tuple(a.shape)} and b {tuple(b.shape)}"
            f" must be ({k},)"
        )
    if x.dtype not in _SOURCES or w.dtype != x.dtype:
        raise TypeError(
            f"fused_bn_relu_matmul: x and w must both be float32 or bfloat16, "
            f"got {x.dtype} and {w.dtype}"
        )
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("fused_bn_relu_matmul: a and b must be float32")
    for name, t in (("x", x), ("a", a), ("b", b), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"fused_bn_relu_matmul: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_bn_relu_matmul: {name} must be contiguous")
    if max(x.shape[0], k, w.shape[1]) >= 2**31:
        raise ValueError("fused_bn_relu_matmul: a dimension exceeds int32")
    # the kernel copies 16-byte pieces of rows: every row starts on 16 bytes
    vec = 16 // x.element_size()
    if k % vec or w.shape[1] % vec:
        raise ValueError(
            f"fused_bn_relu_matmul: K and N must be multiples of {vec} for "
            f"{x.dtype} (rows of whole 16-byte pieces), got K={k}, "
            f"N={w.shape[1]}"
        )
    for name, t in (("x", x), ("a", a), ("b", b), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"fused_bn_relu_matmul: {name} must start on a 16-byte boundary")


@functools.cache
def _launcher(dtype):
    """The C entry of ``dtype``'s kernel, ``<source>_launch(x, a, b, w,
    out, M, K, N, bm, bn, split_k, device, stream)``."""
    name = _SOURCES[dtype]
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, a, b, w, plan=None):
    """Check CUDA operands, launch the kernel of x's dtype on the current
    stream with ``plan`` = (bm, bn, split_k), by default ``launch_plan``'s
    (one of ``plan_tiles(x.dtype)`` and a split up to ``max_split``), and
    return the (M, N) output. Raises on a refused shape or a failed launch;
    counts nothing."""
    _check(x, a, b, w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = plan or launch_plan(m, k, n, sm_count(x.device.index), x.dtype)
    rc = _launcher(x.dtype)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
        out.data_ptr(), m, k, n, *plan, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_bn_relu_matmul: kernel launch {plan} failed with CUDA "
            f"error {rc}"
        )
    return out


def fused_bn_relu_matmul(x, a, b, w):
    """``relu(x * a + b) @ w``. x: (M, K) float32 or bfloat16; a, b: (K,)
    float32; w: (K, N) in x's dtype. Returns (M, N) in x's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel of
    their dtype on the current stream with ``launch_plan``'s plan and add
    one to
    ``fused_bn_relu_matmul.launches``; there K and N must be multiples of
    16 bytes' worth of elements and every operand 16-byte aligned.
    """
    if x.device.type == "cpu":
        return fused_bn_relu_matmul_reference(x, a, b, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_relu_matmul: unsupported device {x.device}")
    out = _launch(x, a, b, w)
    if out.numel():
        fused_bn_relu_matmul.launches += 1
    return out


fused_bn_relu_matmul.launches = 0


def fused_bn_relu_matmul_backward(x, a, b, w, g):
    """``(dx, da, db, dw)`` of ``relu(x * a + b) @ w`` for the output
    gradient ``g``, as the JAX package's ``_bwd`` computes them: the mask is
    ``z > 0``, so a NaN ``z`` gives a zero ``gz`` (and a NaN ``h``, so a NaN
    ``dw``), not torch's relu gradient."""
    x32, g32 = x.float(), g.float()
    z = x32 * a + b
    mask = (z > 0).float()
    h = z * mask
    gz = torch.matmul(g32, w.float().T) * mask  # (M, Cin)
    dx = (gz * a).to(x.dtype)
    da = (gz * x32).sum(0).to(a.dtype)
    db = gz.sum(0).to(b.dtype)
    dw = torch.matmul(h.T, g32).to(w.dtype)
    return dx, da, db, dw


class FusedBnReluMatmul(torch.autograd.Function):
    """``fused_bn_relu_matmul`` under autograd. The forward saves
    ``(x, a, b, w)``, as the custom VJP's ``_fwd`` does (fused_dense.py:88-90);
    the backward is ``fused_bn_relu_matmul_backward``."""

    @staticmethod
    def forward(ctx, x, a, b, w):
        ctx.save_for_backward(x, a, b, w)
        return fused_bn_relu_matmul(x, a, b, w)

    @staticmethod
    def backward(ctx, g):
        return fused_bn_relu_matmul_backward(*ctx.saved_tensors, g)


def bn_relu_conv1x1(x, scale, bias, mean, var, w, eps: float = 1e-5):
    """Channels-last entry point: x (..., Cin) -> (..., Cout), with mean and
    var whichever statistics apply (the batch's in train mode, the running
    ones in eval mode).

    ``a``/``b`` are folded in float32 outside the kernel
    (fused_dense.py:127-128). ``x`` must be viewable as (M, Cin) without a
    copy; ``view`` raises otherwise, so a layout that would cost a copy per
    layer shows up as an error and not as a slowdown.
    """
    a = (scale * torch.rsqrt(var.float() + eps)).float()
    b = (bias - mean * a).float()
    lead = x.shape[:-1]
    out = FusedBnReluMatmul.apply(x.view(-1, x.shape[-1]), a, b, w)
    return out.view(*lead, w.shape[1])
