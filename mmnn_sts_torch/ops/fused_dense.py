"""Fused BatchNorm + ReLU + 1x1x1 convolution: the DenseNet bottleneck.

Counterpart of the JAX package's ops/pallas/fused_dense.py. A 1x1x1 convolution
over channels-last activations is a matmul over (voxels x channels), and the
eval BatchNorm + ReLU before it is an elementwise prologue on the same tile:

    out = relu(x * a + b) @ W,  a = scale / sqrt(var + eps),
                                b = bias - mean * a

On a CUDA tensor ``fused_bn_relu_matmul`` launches the hand-written kernel
(``kernels/csrc/fused_bn_relu_matmul.cu``); on a CPU tensor it computes the
plain PyTorch version, ``fused_bn_relu_matmul_reference``. Nothing falls
back: a build or launch failure raises. Forward only; the backward comes
with the training path.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_bn_relu_matmul_reference(x, a, b, w):
    """Plain version: ``relu(x.float() * a + b)`` rounded to w's dtype, then
    a float32-accumulated product, rounded to x's dtype
    (fused_dense.py:45-50)."""
    h = torch.relu(x.float() * a + b).to(w.dtype)
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
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
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


def _launcher():
    fn = build.load("fused_bn_relu_matmul").fused_bn_relu_matmul_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bn_relu_matmul(x, a, b, w):
    """``relu(x * a + b) @ w``. x: (M, K) float32 or bfloat16; a, b: (K,)
    float32; w: (K, N) in x's dtype. Returns (M, N) in x's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream and add one to ``fused_bn_relu_matmul.launches``.
    """
    if x.device.type == "cpu":
        return fused_bn_relu_matmul_reference(x, a, b, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_relu_matmul: unsupported device {x.device}")
    _check(x, a, b, w)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _launcher()(
        _DTYPE_CODES[x.dtype], x.data_ptr(), a.data_ptr(), b.data_ptr(),
        w.data_ptr(), out.data_ptr(), m, k, n, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_bn_relu_matmul: kernel launch failed with CUDA error {rc}"
        )
    fused_bn_relu_matmul.launches += 1
    return out


fused_bn_relu_matmul.launches = 0


def bn_relu_conv1x1(x, scale, bias, mean, var, w, eps: float = 1e-5):
    """Channels-last entry point: x (..., Cin) -> (..., Cout).

    ``a``/``b`` are folded in float32 outside the kernel
    (fused_dense.py:127-128). ``x`` must be viewable as (M, Cin) without a
    copy; ``view`` raises otherwise, so a layout that would cost a copy per
    layer shows up as an error and not as a slowdown.
    """
    a = (scale * torch.rsqrt(var.float() + eps)).float()
    b = (bias - mean * a).float()
    lead = x.shape[:-1]
    out = fused_bn_relu_matmul(x.view(-1, x.shape[-1]), a, b, w)
    return out.view(*lead, w.shape[1])
