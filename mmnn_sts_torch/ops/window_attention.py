"""Windowed multi-head self-attention with an additive bias (the Swin
encoder's, ``models/swin.py``), on PyTorch's fused SDPA.

``window_attention(qkv, bias, mask, heads)`` takes the qkv Linear's output
of each window, ``(B, W, N, 3C)`` in the compute dtype (``C = heads * d``,
the q, k and v of each token in that order, heads contiguous), the
relative-position bias ``(heads, N, N)`` (float32, its gradient flows)
and, for a shifted block, the shift mask of each window from
``padded_mask``, and returns ``softmax(q kᵀ / sqrt(d) + bias [+ mask]) v``
with the heads concatenated, ``(B, W, N, C)``.

The bias and mask go to the kernel as ``attn_mask`` in the compute dtype,
never expanded over the batch:

* an unshifted block runs as ``B * W`` sequences of ``heads`` heads
  (``q``, ``k``, ``v`` are views of ``qkv``), its mask ``(1, heads, N, N)``
  broadcast by the kernel over the windows;
* a shifted block, whose mask differs from window to window, runs as ``B``
  sequences of ``W * heads`` heads (``q``, ``k``, ``v`` copied into that
  layout), its mask ``(1, W * heads, N, N)`` (the bias added to each
  window's mask) broadcast over the batch.

The mask's rows are allocated ``ALIGN`` elements wide and sliced to N, so
that the memory-efficient kernel's alignment rule copies nothing. Its
backward writes the mask's gradient at the broadcast size, ``B * W * heads
* N * N`` elements of the compute dtype, which autograd then sums over the
batch: the bias table's gradient.

Backends: on CUDA the memory-efficient kernel alone (``fmha_cutlass*``;
cuDNN's SDPA kernels carry ``fprop`` in their names, which the benchmark's
kernel families count as convolution); a call it cannot take raises
instead of falling back to the math path. Elsewhere (the CPU) the math
path. A call whose sequences would exceed the kernel's grid (65,535) runs
in chunks of the batch.

Counters in ``counts`` (host calls, so a CUDA graph replay adds none;
also ``utils/tracing.count`` as ``window_attention.<name>``): ``calls``;
``mask_bytes``, the bytes of the mask materialised for the kernel;
``math_calls``, the calls that ran the math path (0 on a card).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..utils import tracing

ALIGN = 16
MAX_GRID = 65535
MASKED = -100.0

counts = {"calls": 0, "mask_bytes": 0, "math_calls": 0}


def padded_width(n: int) -> int:
    """A mask row's allocated width: N rounded up to ``ALIGN``."""
    return -(-n // ALIGN) * ALIGN


def padded_mask(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (W, N, N) shift mask as the (W, N, ``padded_width(N)``) tensor of
    ``dtype`` that ``window_attention`` takes (made once a grid, by the
    caller)."""
    n = mask.shape[-1]
    return F.pad(mask.to(dtype), (0, padded_width(n) - n))


def _count(name: str, n: int = 1):
    counts[name] += n
    tracing.count(f"window_attention.{name}", n)


def _backend(device: torch.device):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if device.type == "cuda":
        return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])
    _count("math_calls")
    return sdpa_kernel([SDPBackend.MATH])


def _sdpa(q, k, v, attn, scale: float):
    """SDPA over the batch, in chunks no larger than the kernel's grid."""
    with _backend(q.device):
        if q.shape[0] <= MAX_GRID:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=attn,
                                                  scale=scale)
        return torch.cat([F.scaled_dot_product_attention(
            q[s:s + MAX_GRID], k[s:s + MAX_GRID], v[s:s + MAX_GRID],
            attn_mask=attn, scale=scale)
            for s in range(0, q.shape[0], MAX_GRID)])


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor | None, heads: int) -> torch.Tensor:
    """See the module docstring: (B, W, N, 3C) -> (B, W, N, C)."""
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    dt = qkv.dtype
    pad = padded_width(n) - n
    # a fresh row-major tensor even where no padding is needed: the kernel
    # takes only a mask whose last dim has unit stride
    bias = F.pad(bias.to(dt), (0, pad)).contiguous()
    if mask is None:
        q, k, v = qkv.view(b * w, n, 3, heads, d).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = bias.unsqueeze(0)
    else:
        q, k, v = qkv.view(b, w, n, 3, heads, d).permute(
            3, 0, 1, 4, 2, 5).reshape(3, b, w * heads, n, d).unbind(0)
        attn = (bias.unsqueeze(0) + mask.unsqueeze(1)).reshape(
            1, w * heads, n, n + pad)
    _count("calls")
    _count("mask_bytes", attn.numel() * attn.element_size())
    out = _sdpa(q, k, v, attn[..., :n], d ** -0.5)
    return out.view(b, w, heads, n, d).transpose(2, 3).reshape(b, w, n, c)
