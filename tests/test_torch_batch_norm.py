"""The BatchNorm kernels' arithmetic and host rules, on the CPU
(``ops/batch_norm.py``; the kernels themselves run only on the card:
``tests/test_torch_batch_norm_cuda.py``).

* **The backward chain.** ``spec_backward`` writes what
  ``bn_backward_sums_kernel`` and ``bn_backward_dx_kernel`` compute (with
  and without the ReLU, and the fused bottleneck's (da, db) form) in
  closed form in float64, from the forward's float32 statistics as the
  kernels read them from the stats buffer. It is held against autograd of
  the unchanged plain path (``models/common.BatchNorm``, or
  ``densenet.FusedBottleneck.fold``: ``compute_batch_stats`` and the fold)
  unmasked, masked, fully masked, with variances clamped at 0 (E[x^2] -
  mean^2 rounding below 0: no gradient through the variance) and at
  exactly 0 (``torch.maximum``'s tie: half of it). Limit: 1e-4 of the
  largest magnitude among the terms each value sums (float32 autograd
  against float64; the clamped and tied channels multiply by rsqrt(eps) ~
  316 and cancel, so there the variance's share of dx lies under float32's
  rounding, and the share itself is pinned on ``torch.maximum``).
* **The dispatch rule** (``takes_kernels``, ``plain_only``) and its
  counters: which calls run the kernels, that CPU calls count nothing,
  and the counters' names in ``utils/tracing``; the ticket rows refuse a
  stream past the last.
* **The launch geometry** (``plan``, ``vec_width``) at every BatchNorm
  shape of DenseNet121 and the MLP, and at edge shapes.
"""

import math

import numpy as np
import pytest
import torch

from mmnn_sts_torch.models import common
from mmnn_sts_torch.models.common import BatchNorm, compute_batch_stats
from mmnn_sts_torch.models.densenet import FusedBottleneck
from mmnn_sts_torch.ops import batch_norm
from mmnn_sts_torch.parallel import mesh
from mmnn_sts_torch.utils import tracing

torch.set_num_threads(1)

C = 6
CASES = ("unmasked", "masked", "fully-masked", "clamped", "tied")
# (form, relu): a BatchNorm layer with and without the fused ReLU, and the
# fused bottleneck's statistics
FORMS = (("batch_norm", False), ("batch_norm", True), ("bottleneck", False))


def _inputs(case):
    """x (N, C, ...) float32 channels-last, mask or None."""
    rng = np.random.default_rng(CASES.index(case))
    if case in ("clamped", "tied"):
        # two samples a few ulps apart, per channel: E[x^2] - mean^2 rounds
        # below 0 (uniform bases ~1e3, one ulp) or to exactly 0 (two ulps)
        if case == "clamped":
            base = rng.uniform(500.0, 2000.0, C).astype(np.float32)
            far = np.nextafter(base, np.inf)
        else:
            base = np.array([1.0, 3.0, 17.0, 1000.0, 1234.5, 0.7],
                            np.float32)
            far = np.nextafter(np.nextafter(base, np.inf), np.inf)
        return torch.from_numpy(np.stack([base, far])), None
    x = torch.from_numpy(rng.normal(2.0, 1.5, (4, C, 3, 3, 3))
                         .astype(np.float32)).contiguous(
        memory_format=torch.channels_last_3d)
    mask = {"unmasked": None, "masked": [1.0, 0.0, 1.0, 1.0],
            "fully-masked": [0.0] * 4}[case]
    return x, None if mask is None else torch.tensor(mask)


def _row_mask(x, mask):
    if mask is None:
        return torch.ones((), dtype=torch.float64)
    return mask.double().view((-1,) + (1,) * (x.dim() - 1))


def plain_moments(x, mask):
    """(mean, diff, n, valid) as ``compute_batch_stats`` computes them in
    float32: diff = E[x^2] - mean^2 before its clamp, n the denominator."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    if mask is None:
        mean = xf.mean(dims)
        return (mean, xf.square().mean(dims) - mean.square(),
                torch.tensor(float(x.numel() // x.shape[1])),
                torch.tensor(True))
    mf = mask.float().view((-1,) + (1,) * (x.dim() - 1))
    n_valid = mf.sum() * x[0, 0].numel()
    denom = torch.clamp(n_valid, min=1.0)
    mean = (xf * mf).sum(dims) / denom
    diff = (xf.square() * mf).sum(dims) / denom - mean.square()
    valid = n_valid > 0
    return torch.where(valid, mean, 0.0), diff, denom, valid


def spec_backward(x, mask, mean, diff, n, valid, weight, g=None, y=None,
                  da=None, db=None):
    """Kernels 3-5 in float64: ``(dx, dweight, dbias)`` of a BatchNorm for
    the output gradient ``g`` (its ReLU's output ``y`` where one follows),
    or of the bottleneck's statistics for the gradients ``(da, db)`` of
    its fold; each with the magnitude of the terms it sums."""
    x, mean, diff, weight = (t.double() for t in (x, mean, diff, weight))
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    valid = valid.double()
    var = torch.where(valid > 0, torch.clamp(diff, min=0.0), 1.0)
    fvar = torch.where(diff > 0, 1.0, torch.where(diff == 0, 0.5, 0.0))
    fvar = fvar * valid
    rstd = 1.0 / torch.sqrt(var + common.BN_EPS)
    a = rstd * weight
    m = _row_mask(x, mask)
    xc = x - mean.view(shape)
    if g is not None:
        gz = g.double() * m
        if y is not None:
            gz = gz * (y > 0)
        sum_gz, sum_gzx = gz.sum(dims), (gz * xc).sum(dims)
        size_gz, size_gzx = gz.abs().sum(dims), (gz * xc).abs().sum(dims)
        dweight, dbias = sum_gzx * rstd, sum_gz
        dr, dmean_out = sum_gzx * weight, -a * sum_gz
    else:
        da, db = da.double(), db.double()
        da_all = da - db * mean
        size_gz, size_gzx = db.abs(), da.abs() + (db * mean).abs()
        dweight, dbias = da_all * rstd, db
        dr, dmean_out = da_all * weight, -db * a
    ddiff = -0.5 * dr * rstd ** 3 * fvar
    dmean = (dmean_out - 2.0 * mean * ddiff) * valid
    c1, c2 = dmean / n.double(), 2.0 * ddiff / n.double()
    stat = m * (c1.view(shape) + c2.view(shape) * x)
    dx = stat if g is None else gz * a.view(shape) + stat
    # the magnitude of what each value sums (for the limits)
    size_ddiff = (0.5 * size_gzx * weight * rstd ** 3 * fvar).abs()
    size_c = ((size_gz * a + 2 * mean.abs() * size_ddiff) * valid / n
              ).view(shape) + (2 * size_ddiff / n).view(shape) * x.abs()
    size_dx = m * size_c
    if g is not None:
        size_dx = size_dx + (gz * a.view(shape)).abs()
    return ((dx, size_dx), (dweight, size_gzx * rstd), (dbias, size_gz))


def _autograd(form, relu, x, mask, g, ra, rb):
    """The plain path under autograd: ``(dx, dweight, dbias, y)``."""
    torch.manual_seed(0)
    xr = x.clone().requires_grad_()
    if form == "batch_norm":
        module = BatchNorm(C).train()
        with torch.no_grad():
            module.weight.uniform_(0.5, 1.5), module.bias.uniform_(-1, 1)
        y = module(xr, mask, relu=relu)
        y.backward(g)
        return xr.grad, module.weight.grad, module.bias.grad, y.detach(), \
            module.weight.detach()
    module = FusedBottleneck(C, 4).train()
    with torch.no_grad():
        module.scale.uniform_(0.5, 1.5), module.bias.uniform_(-1, 1)
    a, b = module.fold(xr, mask)
    ((a * ra).sum() + (b * rb).sum()).backward()
    return xr.grad, module.scale.grad, module.bias.grad, None, \
        module.scale.detach()


@pytest.mark.parametrize("form,relu", FORMS)
@pytest.mark.parametrize("case", CASES)
def test_backward_chain_spec_against_plain_autograd(case, form, relu):
    x, mask = _inputs(case)
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(x.shape, generator=gen).contiguous(
        memory_format=torch.channels_last_3d if x.dim() == 5
        else torch.contiguous_format)
    ra, rb = torch.randn(C, generator=gen), torch.randn(C, generator=gen)
    dx, dweight, dbias, y, weight = _autograd(form, relu, x, mask, g, ra, rb)
    mean, diff, n, valid = plain_moments(x, mask)
    # the test's moments are compute_batch_stats' own
    ref_mean, ref_var, _, _ = compute_batch_stats(x, mask)
    assert torch.equal(mean, ref_mean)
    assert torch.equal(torch.where(valid, torch.clamp(diff, min=0.0), 1.0),
                       ref_var)
    if case == "clamped":
        assert (diff < 0).any() and (diff > 0).any()
    if case == "tied":
        assert (diff == 0).all()
    if form == "batch_norm":
        spec = spec_backward(x, mask, mean, diff, n, valid, weight, g=g,
                             y=y if relu else None)
    else:
        spec = spec_backward(x, mask, mean, diff, n, valid, weight, da=ra,
                             db=rb)
    for got, (want, size), name in zip((dx, dweight, dbias), spec,
                                       ("dx", "dweight", "dbias")):
        limit = 1e-4 * size.max() + 1e-12
        err = (got.double() - want).abs()
        assert (err <= limit).all(), (name, err.max().item(), limit.item())


@pytest.mark.parametrize("diff,share", [(-1e-6, 0.0), (0.0, 0.5),
                                         (1e-6, 1.0)])
def test_variance_clamp_passes_the_kernels_share(diff, share):
    """The share of the variance's gradient that ``torch.maximum(diff, 0)``
    (``compute_batch_stats``' clamp) passes back to diff: none below 0,
    half at 0, all above: the kernels' FVAR row (``spec_backward``'s
    ``fvar``)."""
    d = torch.tensor(diff, requires_grad=True)
    torch.maximum(d, torch.zeros(())).backward()
    assert d.grad.item() == share


def _cl(shape, dtype=torch.float32):
    fmt = {5: torch.channels_last_3d, 4: torch.channels_last}.get(
        len(shape), torch.contiguous_format)
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=fmt)


@pytest.mark.parametrize("what,x,training,grad,dtype,shard,takes", [
    ("5-D channels-last, train", _cl((2, 16, 4, 4, 4)), True, True, None,
     False, True),
    ("bfloat16", _cl((2, 16, 4, 4, 4), torch.bfloat16), True, True, None,
     False, True),
    ("2-D planes, channels-last", _cl((2, 16, 4, 4)), True, True, None,
     False, True),
    ("the MLP's (N, C)", _cl((8, 12)), True, True, None, False, True),
    ("eval without autograd", _cl((2, 16, 4, 4, 4)), False, False, None,
     False, True),
    ("eval with autograd (Grad-CAM)", _cl((2, 16, 4, 4, 4)), False, True,
     None, False, False),
    ("a mesh shard", _cl((2, 16, 4, 4, 4)), True, True, None, True, False),
    ("contiguous 5-D", torch.zeros((2, 16, 4, 4, 4)), True, True, None,
     False, False),
    ("float64", _cl((2, 16, 4, 4, 4), torch.float64), True, True, None,
     False, False),
    ("a bf16 output of float32", _cl((2, 16, 4, 4, 4)), True, True,
     torch.bfloat16, False, False),
    ("3-D", torch.zeros((2, 16, 4)), True, True, None, False, False),
    ("empty", _cl((0, 16, 4, 4, 4)), True, True, None, False, False),
])
def test_dispatch_rule(what, x, training, grad, dtype, shard, takes):
    real = mesh._active
    mesh._active = object() if shard else None
    try:
        with torch.set_grad_enabled(grad):
            assert batch_norm.takes_kernels(x, training, dtype) is takes, what
    finally:
        mesh._active = real


@pytest.mark.parametrize("training,grad", [(True, True), (False, False),
                                           (False, True)])
@pytest.mark.parametrize("rule", [True, False])
def test_cpu_calls_take_the_plain_path_and_count_nothing(training, grad,
                                                         rule):
    """On the CPU every call is the plain path (``relu`` is ``F.relu`` of
    it) and counts no launch and no plain call, whatever the rule says."""
    torch.manual_seed(1)
    x = torch.randn(3, 8, 4, 4, 4).contiguous(
        memory_format=torch.channels_last_3d)
    module = BatchNorm(8).train(training)
    twin = BatchNorm(8).train(training)
    twin.load_state_dict(module.state_dict())
    counts = batch_norm.launches, batch_norm.plain_calls
    real = batch_norm.takes_kernels
    batch_norm.takes_kernels = lambda *a, **k: rule
    try:
        with torch.set_grad_enabled(grad):
            y = module(x, relu=True)
            want = torch.relu(twin(x))
    finally:
        batch_norm.takes_kernels = real
    assert (batch_norm.launches, batch_norm.plain_calls) == counts
    assert torch.equal(y, want)
    assert torch.equal(module.running_mean, twin.running_mean)


def test_plain_only_turns_the_kernels_off():
    x = _cl((2, 16, 4, 4, 4))
    assert batch_norm.takes_kernels(x, True)
    with batch_norm.plain_only():
        assert not batch_norm.takes_kernels(x, True)
        with batch_norm.plain_only():
            assert not batch_norm.takes_kernels(x, True)
        assert not batch_norm.takes_kernels(x, True)
    assert batch_norm.takes_kernels(x, True)
    with pytest.raises(KeyError), batch_norm.plain_only():
        raise KeyError
    assert batch_norm.takes_kernels(x, True)


def test_ticket_rows_refuse_a_stream_past_the_last(monkeypatch):
    """Each stream gets a row of its own, in order of first use; the
    stream after the ``MAX_SLOTS``-th raises instead of sharing one."""
    monkeypatch.setattr(batch_norm, "_slots", {})
    rows = [batch_norm._slot(1000 + i) for i in range(batch_norm.MAX_SLOTS)]
    assert rows == list(range(batch_norm.MAX_SLOTS))
    assert batch_norm._slot(1003) == 3
    with pytest.raises(RuntimeError, match="streams"):
        batch_norm._slot(1)


def test_counters_go_to_tracing():
    tracing.reset()
    before = batch_norm.plain_calls
    with tracing.epoch(3):
        batch_norm.count_plain()
        batch_norm.count_plain()
    assert batch_norm.plain_calls == before + 2
    assert tracing.records()[3]["counts"] == {"batch_norm.plain_calls": 2}
    tracing.reset()


def test_recomputing_flag():
    assert common.recomputing() is False
    common._recomputing.on = True
    try:
        assert common.recomputing() is True
    finally:
        common._recomputing.on = False


def dn121_bn_shapes(batch=8, side=64):
    """(rows, C) of each BatchNorm (and bottleneck statistics) of a
    DenseNet121 forward at ``batch`` cubes of ``side``, and the MLP's."""
    out = [(batch * (side // 2) ** 3, 64)]
    ch, s = 64, side // 4
    for i, layers in enumerate((6, 12, 24, 16)):
        rows = batch * s ** 3
        out += [(rows, ch + 32 * j) for j in range(layers)] + [(rows, 128)]
        ch += 32 * layers
        out.append((rows, ch))
        ch, s = ch // 2, s // 2
    return out + [(8, w) for w in (32, 16, 8, 8, 8, 12)]


EDGES = [(1, 1), (1, 3), (5, 7), (7, 12), (1000, 3), (64, 2688),
         (262144 * 12, 64), (96, 2049), (33, 40)]


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("rows,channels", dn121_bn_shapes() + EDGES)
def test_plan_covers_every_row_and_channel(rows, channels, reduce):
    sms = 132
    for vec in {batch_norm.vec_width(channels), 4 if channels % 4 == 0
                else 1, 1}:
        grid_x, grid_y, lanes, row_lanes, per_cta = batch_norm.plan(
            rows, channels, vec, sms, reduce)
        threads = lanes * row_lanes
        assert threads <= batch_norm.BLOCK and threads % 32 == 0
        assert row_lanes & (row_lanes - 1) == 0 and lanes <= batch_norm.LANES
        assert per_cta % row_lanes == 0
        assert (grid_x - 1) * per_cta < rows <= grid_x * per_cta
        groups = channels // vec
        assert (grid_y - 1) * lanes < groups <= grid_y * lanes
        if grid_y <= batch_norm.MAX_COLUMNS:
            waves = batch_norm.WAVES[reduce]
            assert grid_x * grid_y <= waves * sms + grid_y
        # at least MIN_PASSES row passes a thread, to within a half where
        # the rows do not split evenly
        passes = per_cta // row_lanes
        assert 2 * passes >= min(batch_norm.MIN_PASSES, math.ceil(
            rows / row_lanes))


def test_vec_width_follows_channels_and_alignment():
    x = torch.zeros(64, 24)
    assert batch_norm.vec_width(24, x) == 8
    assert batch_norm.vec_width(12, x) == 4
    assert batch_norm.vec_width(6, x) == 1
    # a view starting 8 bytes in: float32 groups of 4 or 8 need 16
    assert batch_norm.vec_width(24, x.view(-1)[2:]) == 1
    bf = torch.zeros(64, 24, dtype=torch.bfloat16)
    assert batch_norm.vec_width(24, bf.view(-1)[4:]) == 4  # 8 bytes in
    assert batch_norm.vec_width(24, bf.view(-1)[8:]) == 8  # 16 bytes in


def test_densenet121_fits_the_kernels_columns():
    """Every BatchNorm width of DenseNet121 (and DenseNet-264's widest,
    2,688) is within the kernels' column blocks at 8 channels a thread."""
    for _, channels in dn121_bn_shapes() + [(1, 2688)]:
        x = _cl((1, channels, 1, 1, 1))
        assert batch_norm.takes_kernels(x, True)
