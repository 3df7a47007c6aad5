"""mmnn_sts_torch.ops.fused_dense vs the JAX package's Pallas kernel
(ops/pallas/fused_dense.py, run in interpret mode on the CPU, as
tests/test_pallas.py runs it).

On the CPU the port's wrapper takes the plain PyTorch version, so these tests
hold that plain version against the Pallas kernel. The CUDA kernels (float32
on the CUDA cores, bfloat16 on the tensor cores) are held against the plain
version on the card (the ``cuda`` tests below, and chip_smoke.py over the
whole DenseNet121 shape inventory). JAX is imported
inside a fixture, so that the ``cuda`` tests also run where JAX is not
installed (``--noconftest`` keeps tests/conftest.py, which imports JAX, out):
``python -m pytest tests/test_torch_fused_dense.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from mmnn_sts_torch.ops import fused_dense as fd

torch.set_num_threads(1)

# (m, cin, cout, random affine): the test_pallas.py shapes — a tiled one and
# a ragged one (M not a multiple of the Pallas tile, Cin/Cout narrow)
SHAPES = [(96, 32, 16, True), (700, 16, 8, False)]


@pytest.fixture(scope="module")
def jax_fd():
    pytest.importorskip("jax")
    from mmnn_sts_tpu.ops.pallas import fused_dense

    return fused_dense


def _operands(rng, m, cin, cout, random_affine):
    x = rng.normal(size=(m, cin)).astype(np.float32)
    if random_affine:
        a = rng.uniform(0.5, 2.0, cin).astype(np.float32)
        b = rng.normal(size=cin).astype(np.float32)
    else:
        a = np.ones(cin, np.float32)
        b = np.zeros(cin, np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32)
    return x, a, b, w


@pytest.mark.parametrize("m,cin,cout,random_affine", SHAPES)
def test_reference_matches_pallas_kernel(jax_fd, rng, m, cin, cout, random_affine):
    import jax.numpy as jnp

    x, a, b, w = _operands(rng, m, cin, cout, random_affine)
    want = jax_fd.fused_bn_relu_matmul(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), True)
    got = fd.fused_bn_relu_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_reference_matches_pallas_kernel_bf16(jax_fd, rng):
    """bf16 x/W: h is rounded to bf16 before an f32-accumulated product and
    the output is rounded to bf16 on both sides. Tolerance: a few bf16 ulps
    (2^-8 relative), since the two sums may round differently."""
    import jax.numpy as jnp

    x, a, b, w = _operands(rng, 96, 32, 16, True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = jax_fd.fused_bn_relu_matmul(xb, jnp.asarray(a), jnp.asarray(b),
                                       wb, True)
    got = fd.fused_bn_relu_matmul_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    x, a, b, w = (torch.from_numpy(t) for t in _operands(rng, 64, 8, 4, True))
    before = fd.fused_bn_relu_matmul.launches
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    assert torch.equal(got, fd.fused_bn_relu_matmul_reference(x, a, b, w))
    assert fd.fused_bn_relu_matmul.launches == before  # no kernel launched


def test_bn_relu_conv1x1_matches_jax(jax_fd, rng):
    import jax.numpy as jnp

    n, s, cin, cout = 2, 4, 8, 12
    x = rng.normal(size=(n, s, s, s, cin)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, cin).astype(np.float32)
    bias = rng.normal(size=cin).astype(np.float32)
    mean = rng.normal(size=cin).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cin).astype(np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32)
    want = jax_fd.bn_relu_conv1x1(*(jnp.asarray(t) for t in
                                    (x, scale, bias, mean, var, w)),
                                  interpret=True)
    got = fd.bn_relu_conv1x1(*(torch.from_numpy(t) for t in
                               (x, scale, bias, mean, var, w)))
    assert got.shape == (n, s, s, s, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_bn_relu_conv1x1_refuses_a_copying_layout(rng):
    """A channels-first tensor is not viewable as (M, Cin): the op raises
    instead of copying it."""
    x = torch.randn(2, 8, 4, 4, 4).permute(0, 2, 3, 4, 1)  # not viewable
    with pytest.raises(RuntimeError):
        fd.bn_relu_conv1x1(x, torch.ones(8), torch.zeros(8), torch.zeros(8),
                           torch.ones(8), torch.randn(8, 4))


def _cuda_operands(m, cin, cout, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, cin, device="cuda", generator=g).to(dtype)
    a = torch.rand(cin, device="cuda", generator=g) + 0.5
    b = torch.randn(cin, device="cuda", generator=g)
    w = (torch.randn(cin, cout, device="cuda", generator=g)
         * (2.0 / cin) ** 0.5).to(dtype)
    return x, a, b, w


def _rel_err(got, want):
    return (got.float() - want.float()).abs().max() / want.float().abs().max()


@pytest.mark.parametrize("dtype,k,n,offset", [
    (torch.float32, 30, 128, 0),  # K not a multiple of 4
    (torch.bfloat16, 64, 12, 0),  # N not a multiple of 8
    (torch.float32, 64, 128, 1),  # x starts 4 bytes past a 16-byte boundary
])
def test_check_refuses_rows_of_partial_16_byte_pieces(dtype, k, n, offset):
    """The kernel copies rows in 16-byte pieces: the wrapper's checks refuse
    a K or N that is not whole pieces, or an operand off a 16-byte
    boundary, with a ValueError (checked on CPU tensors; the CUDA wrapper
    runs the same checks before it launches)."""
    m = 8
    x = torch.zeros(m * k + offset, dtype=dtype)[offset:].view(m, k)
    with pytest.raises(ValueError, match="16-byte"):
        fd._check(x, torch.ones(k), torch.zeros(k), torch.zeros(k, n, dtype=dtype))


def test_check_accepts_densenet_rows():
    """Every bottleneck of the registry's DenseNets has K a multiple of 32
    and N = 128: whole 16-byte pieces in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for k in (64, 96, 992):
            fd._check(torch.zeros(8, k, dtype=dtype), torch.ones(k),
                      torch.zeros(k), torch.zeros(k, 128, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,cin,cout", [
    (96, 32, 16), (700, 16, 8), (4096, 224, 128), (8, 992, 128),
    # blocks 3 and 4 of DenseNet121 at buckets 1 and 32: split-K clusters
    (64, 992, 128), (256, 992, 128), (2048, 992, 128),
    # block 1 at buckets 4 (the 64 x 128 tile) and 2 (the 64 x 64 tile)
    *[(m, k, 128) for m in (16384, 8192) for k in range(64, 225, 32)],
])
def test_cuda_kernel_matches_reference(m, cin, cout, dtype, tol):
    """The CUDA kernel vs the plain version on the card (edges masked on M,
    K and N). Tolerance: relative to the largest output, fp32 1e-4, bf16
    2e-2 (output rounded to bf16)."""
    x, a, b, w = _cuda_operands(m, cin, cout, dtype)
    before = fd.fused_bn_relu_matmul.launches
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    torch.cuda.synchronize()
    assert fd.fused_bn_relu_matmul.launches == before + 1
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
    assert got.dtype == dtype and _rel_err(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,cin", [(512, 256), (64, 992), (700, 16),
                                   (8, 992), (65, 40)])
def test_cuda_kernel_nan_rows(m, cin, dtype, tol):
    """A NaN entry of x makes its output row NaN, as jnp.maximum and the
    plain version's relu do (fmaxf would drop it); the other rows agree
    with the plain version within the dtype's tolerance."""
    x, a, b, w = _cuda_operands(m, cin, 128, dtype)
    nan_rows = sorted({1, m // 2, m - 1})
    for r in nan_rows:
        x[r, r % cin] = float("nan")
    got = fd.fused_bn_relu_matmul(x, a, b, w).float()
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w).float()
    torch.cuda.synchronize()
    assert want[nan_rows].isnan().all() and got[nan_rows].isnan().all()
    assert torch.equal(got.isnan().any(1), want.isnan().any(1))
    finite = torch.ones(m, dtype=torch.bool, device="cuda")
    finite[nan_rows] = False
    assert _rel_err(got[finite], want[finite]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_k_is_bit_reproducible(dtype):
    """The split-K cluster sums its ranks' partial tiles in a fixed order,
    so two calls on the same inputs give the same bits."""
    m, cin = 64, 992
    x, a, b, w = _cuda_operands(m, cin, 128, dtype)
    assert fd.launch_plan(m, cin, 128, fd.sm_count(0), dtype)[2] > 1
    first = fd.fused_bn_relu_matmul(x, a, b, w)
    assert all(torch.equal(first, fd.fused_bn_relu_matmul(x, a, b, w))
               for _ in range(5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k,vec", [(torch.float32, 30, 4),
                                         (torch.bfloat16, 36, 8)])
def test_cuda_kernel_refuses_ragged_k(dtype, k, vec):
    """K not whole 16-byte pieces (30 floats, 36 bfloat16s): the wrapper
    raises before it launches, and counts nothing."""
    x, a, b, w = _cuda_operands(64, k, 128, dtype)
    before = fd.fused_bn_relu_matmul.launches
    with pytest.raises(ValueError, match=f"multiples of {vec}"):
        fd.fused_bn_relu_matmul(x, a, b, w)
    assert fd.fused_bn_relu_matmul.launches == before


# the bfloat16 kernel's edges: M below, at and past one 64-row tile, K below
# one 64-deep chunk, not a multiple of it and densenet264-sized, N below,
# at and not a multiple of the 128-wide tile
BF16_EDGES = [(m, k, n) for m in (1, 8, 63, 65) for k in (8, 40, 2720)
              for n in (8, 24, 128, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", BF16_EDGES,
                         ids=[f"M{m}-K{k}-N{n}" for m, k, n in BF16_EDGES])
def test_cuda_bf16_kernel_every_plan(m, k, n):
    """The tensor-core kernel under every plan it takes (each of
    BF16_TILES with every split max_split admits) against the plain
    version, within 2e-2 of the largest output (the output is rounded to
    bfloat16), with the same bits in two calls: the split's rank-order sum
    is fixed. The wrapper's own plan counts one launch."""
    x, a, b, w = _cuda_operands(m, k, n, torch.bfloat16)
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
    for bm, bn in fd.BF16_TILES:
        for split in range(1, fd.max_split(k, torch.bfloat16) + 1):
            got = fd._launch(x, a, b, w, (bm, bn, split))
            again = fd._launch(x, a, b, w, (bm, bn, split))
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (m, n)
            assert _rel_err(got, want) <= 2e-2, (bm, bn, split)
            assert torch.equal(got, again), (bm, bn, split)
    before = fd.fused_bn_relu_matmul.launches
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    torch.cuda.synchronize()
    assert fd.fused_bn_relu_matmul.launches == before + 1
    assert _rel_err(got, want) <= 2e-2


def _densenet121_shapes(batch):
    from mmnn_sts_torch.models import densenet

    return [(m, k) for _, m, k in
            densenet.bottleneck_shapes(densenet.densenet121(), batch)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", _densenet121_shapes(8),
                         ids=[f"M{m}-K{k}" for m, k in _densenet121_shapes(8)])
def test_cuda_bf16_kernel_densenet121(m, k):
    """Every bottleneck of DenseNet121 at batch 8 through the wrapper's
    plan: within 2e-2 of the plain version, the same bits twice, and a NaN
    in x row 3 gives NaN in that output row only."""
    x, a, b, w = _cuda_operands(m, k, 128, torch.bfloat16)
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    again = fd.fused_bn_relu_matmul(x, a, b, w)
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 2e-2 and torch.equal(got, again)
    x[3, k // 2] = float("nan")
    got = fd.fused_bn_relu_matmul(x, a, b, w).float()
    torch.cuda.synchronize()
    nan_rows = got.isnan().any(1)
    assert nan_rows[3] and got[3].isnan().all() and nan_rows.sum() == 1
