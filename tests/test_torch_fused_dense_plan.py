"""The fused bottleneck's host side, on the CPU: the launch plans that
ops/fused_dense.py hands the two CUDA kernels (float32 on the CUDA cores,
bfloat16 on the tensor cores) at every DenseNet121 bottleneck shape and at
edge shapes, the NaN semantics the kernels must keep (held against the JAX
package's Pallas kernel in interpret mode), and the build cache's key.

The kernels themselves run only on the card (tests/test_torch_fused_dense.py's
``cuda`` tests and chip_smoke.py).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mmnn_sts_torch.infer.export import BATCH_SIZES
from mmnn_sts_torch.kernels import build
from mmnn_sts_torch.models import densenet
from mmnn_sts_torch.ops import fused_dense as fd

torch.set_num_threads(1)

N = 128  # DenseNet121's bottleneck width: bn_size 4 x growth 32
SMS = 132  # an H100 SXM's SMs: one wave of CTAs
# every (M, Cin) of DenseNet121's 58 bottlenecks at 64^3, at every batch
# bucket of the servable
SHAPES = sorted({(m, k) for bucket in BATCH_SIZES for _, m, k in
                 densenet.bottleneck_shapes(densenet.densenet121(), bucket)})
# the smallest tile the kernel takes (fused_dense.TILES) and the deepest
# K-split: what the finest plan of a shape could reach
FINEST_BM, FINEST_BN = 16, 32
# shapes at the edges of what the kernels take: M below, at and past one
# 64-row tile; K below one 64-deep chunk, not a multiple of it, and a
# densenet264-sized one
EDGE_SHAPES = [(m, k) for m in (1, 8, 63, 65) for k in (8, 40, 2720)]
# the float32 plans at SHAPES and EDGE_SHAPES as the float32 kernel's
# redesign (split-K clusters) left them: per M, (from K, plan) for every K
# from there to the next entry. The bfloat16 kernel must not move them.
FP32_PLANS = {
    1: ((8, (32, 64, 1)), (2720, (32, 64, 8))),
    8: ((8, (32, 64, 1)), (512, (32, 64, 8))),
    16: ((512, (32, 64, 8)),),
    32: ((512, (32, 64, 8)),),
    63: ((8, (32, 64, 1)), (2720, (32, 64, 8))),
    64: ((256, (32, 64, 4)), (320, (32, 64, 5)), (384, (32, 64, 6)),
         (448, (32, 64, 7)), (512, (32, 64, 8))),
    65: ((8, (32, 64, 1)), (2720, (16, 32, 8))),
    128: ((256, (32, 64, 4)), (320, (16, 32, 5)), (384, (16, 32, 6)),
          (448, (16, 32, 7)), (512, (16, 32, 8))),
    256: ((256, (16, 32, 4)), (320, (32, 32, 5)), (384, (32, 32, 6)),
          (448, (32, 32, 7)), (512, (32, 32, 8))),
    512: ((128, (16, 32, 2)), (192, (32, 32, 3)), (256, (32, 32, 4)),
          (320, (32, 64, 5)), (384, (32, 64, 6)), (448, (32, 64, 7)),
          (512, (32, 64, 8))),
    1024: ((128, (32, 32, 2)), (192, (32, 64, 3)), (256, (32, 64, 4)),
           (320, (32, 64, 5)), (384, (32, 64, 6)), (448, (32, 64, 7)),
           (512, (32, 64, 8))),
    2048: ((128, (32, 64, 2)), (192, (32, 64, 3)), (256, (32, 64, 4))),
    4096: ((64, (32, 64, 1)),),
    8192: ((64, (64, 64, 1)),),
    16384: ((64, (64, 128, 1)),),
    32768: ((64, (128, 128, 1)),),
    65536: ((64, (128, 128, 1)),),
    131072: ((64, (128, 128, 1)),),
}


def k_slices(k, split_k):
    """The K-range of each rank of a cluster, as the kernel computes it:
    rank r walks 32-wide chunks [r*C/S, (r+1)*C/S) of C = ceil(K/32)."""
    chunks = -(-k // fd.BK)
    return [(r * chunks // split_k * fd.BK,
             min(k, (r + 1) * chunks // split_k * fd.BK))
            for r in range(split_k)]


@pytest.mark.parametrize("m,k", SHAPES, ids=[f"M{m}-K{k}" for m, k in SHAPES])
def test_launch_plan(m, k):
    bm, bn, split_k = fd.launch_plan(m, k, N, SMS)
    assert (bm, bn) in fd.TILES
    ctas = fd.plan_ctas(m, N, bm, bn, split_k)
    # the tiles cover M and N
    assert ctas == -(-m // bm) * -(-N // bn) * split_k
    assert -(-m // bm) * bm >= m and -(-N // bn) * bn >= N
    # the K-slices cover K exactly, in order
    slices = k_slices(k, split_k)
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(s[1] == t[0] for s, t in zip(slices, slices[1:]))
    assert 1 <= split_k <= fd.max_split(k) <= fd.MAX_SPLIT == 8
    if k < 128:
        assert split_k == 1
    if split_k > 1:
        assert all(hi - lo >= 64 and lo % 32 == 0 and (hi - lo) % 32 == 0
                   for lo, hi in slices)
    # one wave of 132 CTAs wherever the finest plan reaches it
    finest = (-(-m // FINEST_BM) * -(-N // FINEST_BN)
              * (min(fd.MAX_SPLIT, k // 64) if k >= 128 else 1))
    if finest >= SMS:
        assert ctas >= SMS
    # a split never takes the grid past one round of resident CTAs
    assert split_k == 1 or ctas <= fd.RESIDENT_PER_SM * SMS


ALL_SHAPES = SHAPES + EDGE_SHAPES


@pytest.mark.parametrize("m,k", ALL_SHAPES,
                         ids=[f"M{m}-K{k}" for m, k in ALL_SHAPES])
def test_launch_plan_float32_unchanged(m, k):
    """The float32 kernel keeps its plans, case for case, whatever the
    bfloat16 kernel takes."""
    want = [plan for k_from, plan in FP32_PLANS[m] if k_from <= k][-1]
    assert fd.launch_plan(m, k, N, SMS) == want
    assert fd.launch_plan(m, k, N, SMS, torch.float32) == want


@pytest.mark.parametrize("m,k", ALL_SHAPES,
                         ids=[f"M{m}-K{k}" for m, k in ALL_SHAPES])
def test_launch_plan_bf16(m, k):
    """The bfloat16 kernel's plan: a tile of its own (rows a multiple of
    64, one warpgroup each); unsplit where that tile's grid comes within a
    tenth of a wave, else the 64 x 64 tile with a split <= 8 that leaves
    every rank at least two 64-deep chunks (the kernel takes one) and keeps
    the grid within one wave of resident CTAs."""
    bm, bn, split_k = fd.launch_plan(m, k, N, SMS, torch.bfloat16)
    assert (bm, bn, split_k) == fd.bf16_launch_plan(m, k, N, SMS)
    assert (bm, bn) in fd.BF16_TILES == fd.plan_tiles(torch.bfloat16)
    assert bm % 64 == 0 and bn % 64 == 0
    ctas = fd.plan_ctas(m, N, bm, bn, split_k)
    assert -(-m // bm) * bm >= m and -(-N // bn) * bn >= N
    chunks = -(-k // fd.BF16_BK)
    assert 1 <= split_k <= fd.max_split(k, torch.bfloat16) \
        == min(8, chunks) <= fd.MAX_SPLIT
    # rank r walks chunks [r*C/S, (r+1)*C/S): two or more each
    if split_k > 1:
        assert all((r + 1) * chunks // split_k - r * chunks // split_k >= 2
                   for r in range(split_k))
        assert (bm, bn) == (64, 64) and ctas <= SMS
    # the largest tile that fills the card unsplit
    fills = [t for t in fd.BF16_TILES
             if fd.plan_ctas(m, N, *t, 1) >= fd.BF16_WAVE * SMS]
    if fills:
        assert (bm, bn, split_k) == (*fills[0], 1)
    else:
        # as deep as two chunks a rank and one wave allow
        tiles = fd.plan_ctas(m, N, 64, 64, 1)
        assert split_k == max(1, min(8, chunks // 2, SMS // tiles))


def test_launch_plan_ragged_k():
    """K not a multiple of 32: the slices still cover K, every slice but
    the last ends on a chunk boundary, and each is at least 64 deep."""
    for k in (30, 150, 1000):
        bm, bn, split_k = fd.launch_plan(64, k, N, SMS)
        slices = k_slices(k, split_k)
        assert slices[-1][1] == k
        if split_k > 1:
            assert all(hi - lo >= 64 for lo, hi in slices)
            assert all(hi % 32 == 0 for _, hi in slices[:-1])
    assert fd.launch_plan(700, 30, 8, SMS)[2] == 1


def test_nan_rows_match_pallas_kernel(rng):
    """jnp.maximum(NaN, 0) is NaN: a NaN entry of x makes its output row NaN
    in the Pallas kernel (interpret mode) and in the plain version, and the
    other rows agree (rtol/atol 1e-4, float32 sums in another order)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mmnn_sts_tpu.ops.pallas import fused_dense as jax_fd

    m, cin, cout = 96, 32, 16
    x = rng.normal(size=(m, cin)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, cin).astype(np.float32)
    b = rng.normal(size=cin).astype(np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32)
    nan_rows = [3, 50, 95]
    for r, c in zip(nan_rows, (0, 7, 31)):
        x[r, c] = np.nan
    want = np.asarray(jax_fd.fused_bn_relu_matmul(
        *(jnp.asarray(t) for t in (x, a, b, w)), True))
    got = fd.fused_bn_relu_matmul_reference(
        *(torch.from_numpy(t) for t in (x, a, b, w))).numpy()
    for out in (want, got):
        assert sorted(np.flatnonzero(np.isnan(out).any(1))) == nan_rows
        assert np.isnan(out[nan_rows]).all()
    finite = np.setdiff1d(np.arange(m), nan_rows)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4, atol=1e-4)


def test_library_path_follows_every_csrc_file(tmp_path):
    """The built library's name changes when any file under csrc/ changes
    (a header the kernel includes, or a new one), not only its .cu."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    with mock.patch.object(build, "CSRC", tmp_path):
        first = build.library_path("k")
        assert build.library_path("k") == first
        (tmp_path / "k.cuh").write_text("// v2\n")
        edited = build.library_path("k")
        (tmp_path / "extra.cuh").write_text("// new\n")
        added = build.library_path("k")
        with mock.patch.object(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",)):
            flagged = build.library_path("k")
    assert len({first, edited, added, flagged}) == 4
    assert first.name.startswith("libk-") and first.suffix == ".so"


def test_library_path_follows_the_bf16_source(tmp_path):
    """Each dtype's kernel has its own source under csrc/ and its own
    library, and an edit of the bfloat16 source rebuilds both libraries
    (the key hashes every file), so a stale one is never loaded."""
    assert sorted(fd._SOURCES.values()) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    for name in fd._SOURCES.values():
        (tmp_path / f"{name}.cu").write_text("// v1\n")
    with mock.patch.object(build, "CSRC", tmp_path):
        before = {name: build.library_path(name)
                  for name in fd._SOURCES.values()}
        (tmp_path / "fused_bn_relu_matmul_bf16.cu").write_text("// v2\n")
        after = {name: build.library_path(name)
                 for name in fd._SOURCES.values()}
    assert len(set(before.values())) == 2
    assert all(before[name] != after[name] for name in before)
    assert after["fused_bn_relu_matmul_bf16"].name.startswith(
        "libfused_bn_relu_matmul_bf16-")
