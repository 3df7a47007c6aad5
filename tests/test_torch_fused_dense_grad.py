"""The fused bottleneck under autograd: mmnn_sts_torch.ops.fused_dense's
``FusedBnReluMatmul`` (forward: the wrapper; backward: the JAX package's
``_bwd`` in plain PyTorch) against ``jax.vjp`` of the Pallas kernel's custom
VJP, run in interpret mode on the CPU as tests/test_pallas.py runs it.

On the CPU the Function's forward is the plain version; the ``cuda`` tests
hold the kernel forward + ``_bwd`` against torch autograd through the plain
version on the card:
``python -m pytest tests/test_torch_fused_dense_grad.py -m cuda --noconftest``.
Tolerances: rtol/atol 1e-4 on the CPU (float32, other summation orders);
on the card 1e-4 x max |plain| per output. NaN entries must sit at the same
places on both sides.
"""

import numpy as np
import pytest
import torch

from mmnn_sts_torch.ops import fused_dense as fd

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_fd():
    pytest.importorskip("jax")
    from mmnn_sts_tpu.ops.pallas import fused_dense

    return fused_dense


def _operands(seed, m, cin, cout, nan_rows=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, cin)).astype(np.float32)
    for r in nan_rows:
        x[r, r % cin] = np.nan
    a = rng.uniform(0.5, 2.0, cin).astype(np.float32)
    b = rng.normal(size=cin).astype(np.float32)
    w = rng.normal(size=(cin, cout)).astype(np.float32)
    g = rng.normal(size=(m, cout)).astype(np.float32)
    return x, a, b, w, g


def _port_vjp(x, a, b, w, g):
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, a, b, w)]
    out = fd.FusedBnReluMatmul.apply(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("m,cin,cout,nan_rows", [
    (96, 32, 16, ()),
    (700, 16, 8, ()),  # M not a multiple of the Pallas tile
    (96, 32, 16, (1, 50, 95)),  # a NaN in x: its row, da and dw go NaN
])
def test_function_matches_pallas_vjp(jax_fd, m, cin, cout, nan_rows):
    import jax
    import jax.numpy as jnp

    x, a, b, w, g = _operands(m + cin, m, cin, cout, nan_rows)
    want_out, vjp = jax.vjp(
        lambda *t: jax_fd.fused_bn_relu_matmul(*t, True),
        *(jnp.asarray(t) for t in (x, a, b, w)))
    want = vjp(jnp.asarray(g))
    before = fd.fused_bn_relu_matmul.launches
    got_out, got = _port_vjp(x, a, b, w, g)
    assert fd.fused_bn_relu_matmul.launches == before  # CPU: plain version
    np.testing.assert_allclose(got_out, np.asarray(want_out), **TOL)
    for name, gp, gj in zip("dx da db dw".split(), got, want):
        gj = np.asarray(gj)
        assert gp.shape == gj.shape and gp.dtype == gj.dtype, name
        np.testing.assert_array_equal(np.isnan(gp), np.isnan(gj), name)
        np.testing.assert_allclose(gp, gj, **TOL, err_msg=name)
    if nan_rows:
        assert np.isnan(got[1]).any() and np.isnan(got[3]).any()
        assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()


def test_bn_relu_conv1x1_grads_match_jax(jax_fd):
    """The entry point with a and b folded from (scale, bias, mean, var)
    under autograd: gradients reach all six inputs as in JAX."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n, s, cin, cout = 2, 4, 8, 12
    arrays = [rng.normal(size=(n, s, s, s, cin)),
              rng.uniform(0.5, 2.0, cin), rng.normal(size=cin),
              rng.normal(size=cin), rng.uniform(0.5, 2.0, cin),
              rng.normal(size=(cin, cout))]
    arrays = [np.asarray(t, np.float32) for t in arrays]
    g = rng.normal(size=(n, s, s, s, cout)).astype(np.float32)
    want = jax.grad(
        lambda *t: jnp.sum(jax_fd.bn_relu_conv1x1(*t, interpret=True) * g),
        argnums=tuple(range(6)))(*(jnp.asarray(t) for t in arrays))
    ts = [torch.from_numpy(t).requires_grad_() for t in arrays]
    (fd.bn_relu_conv1x1(*ts) * torch.from_numpy(g)).sum().backward()
    for name, t, gj in zip("x scale bias mean var w".split(), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), **TOL,
                                   err_msg=name)


def _cuda_case(m, cin, nan_rows=()):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    x, a, b, w, g = (torch.from_numpy(t).cuda() for t in
                     _operands(m + cin, m, cin, 128, nan_rows))
    return x, a, b, w * (2.0 / cin) ** 0.5, g


def _close(got, want, tol=1e-4):
    """Same NaN places, and the finite entries within tol x max |want|."""
    if not torch.equal(got.isnan(), want.isnan()):
        return False
    fin = ~want.isnan()
    scale = max(want[fin].abs().max().item(), 1e-30) if fin.any() else 1.0
    return (got[fin] - want[fin]).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,cin,nan_rows", [
    (32768, 64, ()), (32768, 224, ()), (4096, 480, ()), (512, 992, ()),
    (64, 992, ()), (4096, 256, (1, 2048, 4095)),
])
def test_cuda_backward_matches_autograd_of_plain(m, cin, nan_rows):
    """DenseNet121 bottleneck shapes at microbatch 8: the Function (kernel
    forward, then _bwd) against torch autograd through the plain version:
    the output and dx, da, db, dw."""
    x, a, b, w, g = _cuda_case(m, cin, nan_rows)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
    before = fd.fused_bn_relu_matmul.launches
    out = fd.FusedBnReluMatmul.apply(*leaves)
    out.backward(g)
    assert fd.fused_bn_relu_matmul.launches == before + 1
    plain = [t.clone().requires_grad_() for t in (x, a, b, w)]
    want = fd.fused_bn_relu_matmul_reference(*plain)
    want.backward(g)
    torch.cuda.synchronize()
    assert _close(out.detach(), want.detach())
    for name, t, p in zip("dx da db dw".split(), leaves, plain):
        assert _close(t.grad, p.grad), name
