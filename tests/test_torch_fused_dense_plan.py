"""The fused bottleneck's host side, on the CPU: the launch plan that
ops/fused_dense.py hands the CUDA kernel at every DenseNet121 bottleneck
shape, the NaN semantics the kernel must keep (held against the JAX
package's Pallas kernel in interpret mode), and the build cache's key.

The kernel itself runs only on the card (tests/test_torch_fused_dense.py's
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
