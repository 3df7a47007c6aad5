"""The float64 witness of the BatchNorm kernels (``ops/batch_norm.py``)
and of the plain path they replace, shared by
``tests/test_torch_batch_norm_cuda.py`` and ``chip_smoke.py``'s BatchNorm
phase; imports no JAX.

Both paths sum in float32 in different orders, so each is measured
against the same module run in float64 on the same inputs (``exact_bn``,
``exact_fold``): the kernels' largest error may be at most ``RATIO``
times the plain path's plus ``FLOOR`` of the float64 values' largest
magnitude (the statistics' part of dx, c1 + c2 x, cancels to c2 (x -
mean), so either path's float32 mean error shows there magnified: 3e-6
of the magnitude at block 4's 40 valid rows in float32).

Where a ReLU follows, an output within float32 rounding of 0 may fall on
either side of it on either path (their float32 statistics differ in
the last bits), and each such element moves dweight and dbias by about
|g|. So each path's backward is held to the witness under the path's own
ReLU mask (``passed``): its output then agrees with the witness's
except where the witness lies next to 0, and the comparison of the
outputs catches a mask that is wrong elsewhere. dx is not compared at the
elements whose float64 output lies within ``NEAR_ZERO`` of the largest.
"""

import torch

from mmnn_sts_torch.models import common

RATIO, FLOOR, NEAR_ZERO = 3.0, 1e-5, 1e-3
BN_VALUES = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
FOLD_VALUES = ("a", "b", "dx", "dscale", "dbias", "mean", "var")


def randomise(module, seed):
    """Every parameter and buffer of ``module`` uniform in [0.5, 1.5)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.copy_(torch.rand(t.shape, generator=g, device="cuda") + 0.5)


def run_bn(module, x, up, mask, relu):
    """A BatchNorm module's train step on x with the output's gradient
    ``up``: the values of ``BN_VALUES``."""
    x = x.detach().requires_grad_()
    y = module(x, mask, relu=relu)
    y.backward(up)
    return (y.detach(), x.grad, module.weight.grad, module.bias.grad,
            module.running_mean.clone(), module.running_var.clone())


def run_fold(module, x, ra, rb, mask):
    """A FusedBottleneck's statistics folded (``fold``) with the gradient
    of ``sum(a ra) + sum(b rb)``: the values of ``FOLD_VALUES``."""
    x = x.detach().requires_grad_()
    a, b = module.fold(x, mask)
    ((a * ra).sum() + (b * rb).sum()).backward()
    return (a.detach(), b.detach(), x.grad, module.scale.grad,
            module.bias.grad, module.mean.clone(), module.var.clone())


def exact_stats(x, mask):
    """The plain formula's (mean, var, unbiased, any_valid) in float64."""
    dims = (0,) + tuple(range(2, x.dim()))
    if mask is None:
        n = x.numel() // x.shape[1]
        mean, msq = x.mean(dims), (x * x).mean(dims)
        var = torch.clamp(msq - mean * mean, min=0.0)
        return mean, var, var * (n / max(n - 1, 1)), torch.tensor(
            True, device=x.device)
    mf = mask.double().view((-1,) + (1,) * (x.dim() - 1))
    n = mf.sum() * x[0, 0].numel()
    denom = n.clamp(min=1.0)
    mean = (x * mf).sum(dims) / denom
    var = torch.clamp((x * x * mf).sum(dims) / denom - mean * mean, min=0.0)
    valid = n > 0
    mean = torch.where(valid, mean, torch.zeros_like(mean))
    var = torch.where(valid, var, torch.ones_like(var))
    return mean, var, var * (n / (n - 1).clamp(min=1.0)), valid


def _exact_update(running, batch, valid):
    m = common.BN_MOMENTUM
    new = m * running.double() + (1 - m) * batch.detach()
    return torch.where(valid, new, running.double())


def exact_bn(module, x, up, mask, relu, passed=None):
    """``run_bn`` in float64 (the witness), from ``module``'s state; the
    ReLU passes where ``passed`` (a path's own output > 0) if given."""
    w, b = (p.detach().double().requires_grad_()
            for p in (module.weight, module.bias))
    xr = x.detach().double().requires_grad_()
    mean, var, unbiased, valid = exact_stats(xr, mask)
    shape = (-1,) + (1,) * (x.dim() - 2)
    y = (xr - mean.view(shape)) * (torch.rsqrt(var + common.BN_EPS)
                                   * w).view(shape) + b.view(shape)
    if mask is not None:
        y = y * mask.double().view((-1,) + (1,) * (x.dim() - 1))
    if relu:
        y = torch.relu(y) if passed is None else y * passed.double()
    y.backward(up.double())
    return (y.detach(), xr.grad, w.grad, b.grad,
            _exact_update(module.running_mean, mean, valid),
            _exact_update(module.running_var, unbiased, valid))


def exact_fold(module, x, ra, rb, mask):
    """``run_fold`` in float64 (the witness), from ``module``'s state."""
    scale, bias = (p.detach().double().requires_grad_()
                   for p in (module.scale, module.bias))
    xr = x.detach().double().requires_grad_()
    mean, var, unbiased, valid = exact_stats(xr, mask)
    a = scale * torch.rsqrt(var + common.BN_EPS)
    b = bias - mean * a
    ((a * ra.double()).sum() + (b * rb.double()).sum()).backward()
    return (a.detach(), b.detach(), xr.grad, scale.grad, bias.grad,
            _exact_update(module.mean, mean, valid),
            _exact_update(module.var, unbiased, valid))


def errors(kernel, plain, exact, names, relu=False):
    """``(name, kernels' error, limit)`` for each value of ``run_bn`` or
    ``run_fold`` on the kernels and on the plain path: each path's largest
    absolute distance to its witness, ``exact(path's values)`` (the
    path's own ReLU mask), and the limit ``RATIO`` x the plain path's +
    ``FLOOR`` x the witness's largest magnitude. With ``relu`` dx leaves
    out the elements near 0."""
    witness = {"kernel": exact(kernel), "plain": exact(plain)}
    keep = None
    if relu:
        y = witness["plain"][0]
        keep = y.abs() > NEAR_ZERO * y.abs().max()
        keep = keep if keep.any() else None
    out = []
    for i, name in enumerate(names):
        pair = []
        for got, e in ((kernel[i], witness["kernel"][i]),
                       (plain[i], witness["plain"][i])):
            if keep is not None and name == "dx":
                got, e = got[keep], e[keep]
            pair.append(((got.double() - e.double()).abs().max().item(),
                         e.double().abs().max().item()))
        (ek, _), (ep, scale) = pair
        out.append((name, ek, RATIO * ep + FLOOR * scale))
    return out
