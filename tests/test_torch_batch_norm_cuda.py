"""The BatchNorm kernels on the card (``ops/batch_norm.py``,
``kernels/csrc/batch_norm.cu``) against the plain path of
``models/common.BatchNorm`` / ``compute_batch_stats`` (the same modules
with the kernels turned off), in float32 and bfloat16, at every BatchNorm
shape of DenseNet121 at batch 8 (64^3 volumes) and the clinical MLP's
(8, C), unmasked, masked (a tail of 5 valid samples of 8) and fully
masked. Each case checks the output, the running statistics, the folded
``a``, ``b`` of the bottleneck and the gradients of x, weight and bias.

Both paths are measured against the same module run in float64 on the
same inputs (``tests/bn_witness.py``; each path's backward under its own
ReLU mask): the kernels' largest error may be at most 3 times the plain
path's plus 1e-5 of the float64 values' largest magnitude.

Then: two runs give the same bits; a captured CUDA graph replays the
eager bits (the ticket counters reset themselves); ``TPU.remat``'s
recompute folds no statistics in a second time; the dispatch rule (a
mesh shard, eval mode with gradients) keeps the plain path and counts it
in ``plain_calls``; ``launches`` counts the host launches.

Skips without a card; imports no JAX:
``python -m pytest tests/test_torch_batch_norm_cuda.py -m cuda --noconftest``.
"""

import contextlib
import copy

import pytest
import torch
from bn_witness import (
    BN_VALUES,
    FOLD_VALUES,
    NEAR_ZERO,
    errors,
    exact_bn,
    exact_fold,
    randomise,
    run_bn,
    run_fold,
)

from mmnn_sts_torch.models import common
from mmnn_sts_torch.models.common import BatchNorm
from mmnn_sts_torch.models.densenet import DenseNet, FusedBottleneck
from mmnn_sts_torch.ops import batch_norm
from mmnn_sts_torch.parallel import mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MASKS = {"unmasked": None, "tail": [1, 1, 1, 1, 1, 0, 0, 0],
         "none-valid": [0] * 8}


def dn121_shapes(batch=8, side=64):
    """(kind, shape (N, C, *spatial)) of each distinct BatchNorm call of a
    DenseNet121 forward at ``batch`` cubes of ``side``, in call order; the
    clinical MLP's (8, C) last. kind: "relu" (norm0, norm2, transitions:
    the ReLU fused), "plain" (norm5, the MLP), "fused" (a bottleneck's
    statistics)."""
    out = [("relu", (batch, 64) + (side // 2,) * 3)]
    ch, s = 64, side // 4
    for i, layers in enumerate((6, 12, 24, 16)):
        out += [("fused", (batch, ch + 32 * j) + (s,) * 3)
                for j in range(layers)]
        out.append(("relu", (batch, 128) + (s,) * 3))
        ch += 32 * layers
        if i < 3:
            out.append(("relu", (batch, ch) + (s,) * 3))
            ch, s = ch // 2, s // 2
        else:
            out.append(("plain", (batch, ch) + (s,) * 3))
    return out + [("plain", (8, w)) for w in (32, 16, 8, 12)]


SHAPES = dn121_shapes()


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the BatchNorm kernels run only "
                    "there)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _fmt(shape):
    return {5: torch.channels_last_3d, 4: torch.channels_last}.get(
        len(shape), torch.contiguous_format)


def _inputs(shape, dtype, mask, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (3.0 + 2.0 * torch.randn(shape, generator=g, device="cuda")
         ).to(dtype).contiguous(memory_format=_fmt(shape))
    up = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(
        memory_format=_fmt(shape))
    m = None if mask is None else torch.tensor(mask, dtype=torch.float32,
                                               device="cuda")
    return x, up, m


def _check(runs, exact, names, where, relu=False):
    for name, err, limit in errors(runs["kernel"], runs["plain"], exact,
                                   names, relu):
        assert err <= limit, (f"{name} {where}", err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_batch_norm_against_plain_at_densenet121_shapes(dtype, mask):
    dt = DTYPES[dtype]
    for i, (kind, shape) in enumerate(SHAPES):
        if kind == "fused":
            continue
        x, up, m = _inputs(shape, dt, MASKS[mask], i)
        module = BatchNorm(shape[1]).cuda().train()
        randomise(module, i)
        relu = kind == "relu"
        runs = {}
        before = batch_norm.launches
        runs["kernel"] = run_bn(copy.deepcopy(module), x, up, m, relu)
        assert batch_norm.launches - before == 4, shape
        with batch_norm.plain_only():
            runs["plain"] = run_bn(copy.deepcopy(module), x, up, m, relu)
        _check(runs, lambda out: exact_bn(
            module, x, up, m, relu, out[0] > 0 if relu else None),
            BN_VALUES, f"{dtype} {mask} {shape}", relu)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_bottleneck_statistics_against_plain(dtype, mask):
    """The fused bottleneck's statistics at DenseNet121's 58 shapes:
    ``a``, ``b``, the running update and the gradients of x, scale and
    bias for given (da, db); then one bottleneck's output on both paths."""
    dt = DTYPES[dtype]
    for i, (kind, shape) in enumerate(SHAPES):
        if kind != "fused":
            continue
        x, _, m = _inputs(shape, dt, MASKS[mask], i)
        module = FusedBottleneck(shape[1], 128, dt).cuda().train()
        randomise(module, i)
        g = torch.Generator(device="cuda").manual_seed(i)
        ra, rb = (torch.randn(shape[1], generator=g, device="cuda")
                  for _ in range(2))
        runs = {"kernel": run_fold(copy.deepcopy(module), x, ra, rb, m)}
        with batch_norm.plain_only():
            runs["plain"] = run_fold(copy.deepcopy(module), x, ra, rb, m)
        _check(runs, lambda out: exact_fold(module, x, ra, rb, m),
               FOLD_VALUES, f"{dtype} {mask} {shape}")
    # the whole bottleneck, forward and backward, at block 1's widest
    shape = [s for k, s in SHAPES if k == "fused"][5]
    x, _, m = _inputs(shape, dt, MASKS[mask], 99)
    module = FusedBottleneck(shape[1], 128, dt).cuda().train()
    randomise(module, 99)
    outs = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", batch_norm.plain_only())):
        with ctx:
            copy_ = copy.deepcopy(module)
            xr = x.detach().requires_grad_()
            y = copy_(xr, m)
            y.float().square().sum().backward()
            outs[name] = (y.detach().float(), xr.grad.float())
    # dx leaves out the elements whose ReLU input z = x a + b lies within
    # NEAR_ZERO of 0: there the fused op's mask may take either side
    mean, var, _, _ = common.compute_batch_stats(x, m)
    a = module.scale * torch.rsqrt(var + common.BN_EPS)
    z = x.float() * a.view(-1, 1, 1, 1) + (module.bias - mean * a).view(
        -1, 1, 1, 1)
    keep = z.abs() > NEAR_ZERO * z.abs().max()
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for k, where in enumerate((None, keep)):
        got, ref = outs["kernel"][k], outs["plain"][k]
        if where is not None:
            got, ref = got[where], ref[where]
        assert (got - ref).abs().max() <= tol * ref.abs().max(), k


def _bn_step(module, x, up, mask):
    y = module(x.detach().requires_grad_(), mask, relu=True)
    y.backward(up)
    return [y.detach().clone(), module.weight.grad.clone(),
            module.bias.grad.clone(), module.running_mean.clone(),
            module.running_var.clone()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_batch_norm_repeats_its_bits_and_replays_in_a_graph(dtype):
    """Two eager runs give the same bits; a captured forward and backward
    replays them (twice, so the tickets were reset)."""
    dt = DTYPES[dtype]
    shape = SHAPES[0][1]  # norm0: the most CTAs a column
    x, up, m = _inputs(shape, dt, MASKS["tail"], 7)
    module = BatchNorm(64).cuda().train()
    randomise(module, 7)
    runs = []
    for _ in range(2):
        mod = copy.deepcopy(module)
        runs.append(_bn_step(mod, x, up, m))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    mod = copy.deepcopy(module)
    xs, ups = x.clone(), up.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the allocator meets the shapes
        _bn_step(copy.deepcopy(module), xs, ups, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xr = xs.detach().requires_grad_()
        y = mod(xr, m, relu=True)
        y.backward(ups)
    for step in range(2):
        with torch.no_grad():
            mod.weight.grad.zero_(), mod.bias.grad.zero_()
            mod.running_mean.copy_(module.running_mean)
            mod.running_var.copy_(module.running_var)
        before = batch_norm.launches
        graph.replay()
        torch.cuda.synchronize()
        assert batch_norm.launches == before
        got = [y, mod.weight.grad, mod.bias.grad, mod.running_mean,
               mod.running_var]
        for a, b in zip(got, runs[0]):
            assert torch.equal(a, b), step


@pytest.mark.cuda
def test_cuda_remat_recompute_folds_statistics_once():
    """A DenseNet under ``TPU.remat`` and without it: the same running
    statistics and gradients, bit for bit (the recompute runs the kernels
    with no running update)."""
    torch.backends.cudnn.deterministic = True
    kw = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 16, 16, 16, 2), generator=g, device="cuda")
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device="cuda")
    torch.manual_seed(0)
    base = DenseNet(**kw).cuda().train()
    out = {}
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.remat = remat
        model(x, sample_mask=mask).square().sum().backward()
        out[remat] = ([b.clone() for b in model.buffers()],
                      [p.grad.clone() for p in model.parameters()])
    for a, b in zip(out[False][0] + out[False][1],
                    out[True][0] + out[True][1]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        out[False][0], [b for b in base.buffers()]))


class _Whole:
    """A mesh shard whose ranks each hold the whole batch (the plain path's
    statistics then need no collective)."""

    def holding(self, x):
        return None


@pytest.mark.cuda
def test_cuda_dispatch_rule_counts_plain_calls():
    """Train mode on the card runs the kernels (4 launches a call with its
    backward); under a mesh shard and in eval mode with gradients the
    plain path runs and counts one call each; eval mode without gradients
    is one launch."""
    x, up, _ = _inputs((2, 16, 4, 4, 4), torch.float32, None, 1)
    module = BatchNorm(16).cuda().train()
    launches, plains = batch_norm.launches, batch_norm.plain_calls
    module(x.requires_grad_(), relu=True).backward(up)
    assert (batch_norm.launches - launches,
            batch_norm.plain_calls - plains) == (4, 0)
    module.eval()
    with torch.no_grad():
        module(x)
    assert batch_norm.launches - launches == 5
    module(x)  # eval with gradients: Grad-CAM's
    assert batch_norm.plain_calls - plains == 1
    module.train()
    real = mesh._active
    mesh._active = _Whole()
    try:
        module(x)
    finally:
        mesh._active = real
    assert batch_norm.plain_calls - plains == 2
    assert batch_norm.launches - launches == 5
