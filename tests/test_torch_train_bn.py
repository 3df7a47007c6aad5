"""The port's models in train mode, held against the JAX package's flax
modules: ``BatchNorm`` and ``FusedBottleneck`` (its Pallas kernel in
interpret mode, as tests/test_pallas.py runs it) in train and eval mode,
with and without a sample mask, a fully masked batch, a single valid sample
and an input whose E[x^2] - mean^2 rounds negative. Each case compares the
output, the running statistics after the update and the gradients of
sum(out * r) for a random r with respect to the input and the parameters.
Tolerance rtol/atol 1e-4 (float32, other summation orders; a zero-variance
channel multiplies by rsqrt(eps) ~ 316, so its outputs compare within
1e-4 x 316).

Dropout and the initialisers cannot match JAX's random streams, so they are
tested statistically: the drop rate, the per-channel broadcast, the
1 / (1 - p) scaling, and each layer's standard deviation against the JAX
package's rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.models.common import BatchNorm as JaxBatchNorm
from mmnn_sts_tpu.models.densenet import FusedBottleneck as JaxFusedBottleneck
from mmnn_sts_torch.models.common import (
    BatchNorm, Dropout, compute_batch_stats)
from mmnn_sts_torch.models.densenet import FusedBottleneck, densenet121
from mmnn_sts_torch.models.mlp import MLP

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
C_IN, C_OUT = 8, 16

# name -> (per-sample shape in the JAX layout, sample mask or None, train)
CASES = {
    "eval": ((3, 3, 3, C_IN), None, False),
    "train": ((3, 3, 3, C_IN), None, True),
    "train-ragged": ((3, 3, 3, C_IN), [1, 1, 1, 0], True),
    "train-fully-masked": ((3, 3, 3, C_IN), [0, 0, 0, 0], True),
    "train-one-valid": ((3, 3, 3, C_IN), [0, 1, 0, 0], True),
    "train-1d-one-valid": ((C_IN,), [0, 0, 1, 0], True),
    "train-1d-ragged": ((C_IN,), [1, 0, 1, 1], True),
    # two samples a hair apart at ~1e3: the variance rounds negative
    "train-negative-var": ((C_IN,), None, True),
}


def _case_inputs(name):
    shape, mask, train = CASES[name]
    rng = np.random.default_rng(len(name))
    if name == "train-negative-var":
        base = rng.uniform(500.0, 2000.0, shape).astype(np.float32)
        x = np.stack([base, np.nextafter(base, np.inf)])
    else:
        x = rng.normal(1.0, 2.0, (4,) + shape).astype(np.float32)
    stats = (rng.normal(0.0, 0.2, C_IN).astype(np.float32),
             rng.uniform(0.5, 1.5, C_IN).astype(np.float32))
    affine = (rng.uniform(0.5, 1.5, C_IN).astype(np.float32),
              rng.normal(0.0, 0.2, C_IN).astype(np.float32))
    mask = None if mask is None else np.asarray(mask, np.float32)
    return x, mask, train, stats, affine, rng


def _to_port(x):
    """JAX (N, ..., C) -> port (N, C, ...), channels-last in memory."""
    t = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    return t.contiguous(memory_format=torch.channels_last_3d) \
        if t.dim() == 5 else t


def _from_port(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _jax_run(module, params, batch_stats, x, mask, r, train, call):
    """Output, new batch_stats and grads (params, x) of sum(out * r)."""
    def f(p, xx):
        variables = {"params": p, "batch_stats": batch_stats}
        if train:
            out, mut = call(module, variables, xx, mask, mutable=["batch_stats"])
        else:
            out, mut = call(module, variables, xx, mask), {
                "batch_stats": batch_stats}
        return jnp.sum(out * r), (out, mut["batch_stats"])

    (_, (out, bs)), grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return out, bs, grads


def _port_run(module, x, mask, r, train):
    xt = _to_port(x).requires_grad_()
    module.train(train)
    out = module(xt, None if mask is None else torch.from_numpy(mask))
    (out * _to_port(r)).sum().backward()
    return out, xt.grad


@pytest.mark.parametrize("case", list(CASES))
def test_batchnorm_matches_flax(case):
    x, mask, train, (mean, var), (scale, bias), rng = _case_inputs(case)
    r = rng.normal(size=x.shape).astype(np.float32)
    jm = JaxBatchNorm(use_running_average=not train)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}}
    bs = {"BatchNorm_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    want, want_bs, (gp, gx) = _jax_run(
        jm, params, bs, x, None if mask is None else jnp.asarray(mask), r,
        train, lambda m, v, xx, mk, **kw: m.apply(v, xx, mk, **kw))

    bn = BatchNorm(C_IN)
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (scale, bias, mean, var)):
            t.copy_(torch.from_numpy(v))
    out, dx = _port_run(bn, x, mask, r, train)
    atol = 316 * TOL["atol"] if case == "train-negative-var" else TOL["atol"]
    np.testing.assert_allclose(_from_port(out), np.asarray(want),
                               rtol=TOL["rtol"], atol=atol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_bs["BatchNorm_0"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want_bs["BatchNorm_0"]["var"]), **TOL)
    for got, want_g in ((_from_port(dx), gx),
                        (bn.weight.grad.numpy(), gp["BatchNorm_0"]["scale"]),
                        (bn.bias.grad.numpy(), gp["BatchNorm_0"]["bias"])):
        scale_g = max(1.0, float(np.abs(want_g).max()))
        np.testing.assert_allclose(got, np.asarray(want_g), rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale_g)
    if case == "train-fully-masked":  # running stats untouched, rows zeroed
        assert np.array_equal(bn.running_mean.numpy(), mean)
        assert not out.detach().any()


@pytest.mark.parametrize("case", [c for c in CASES
                                  if len(CASES[c][0]) == 4])
def test_fused_bottleneck_matches_flax(case):
    x, mask, train, (mean, var), (scale, bias), rng = _case_inputs(case)
    kernel = rng.normal(0.0, 0.5, (C_IN, C_OUT)).astype(np.float32)
    r = rng.normal(size=x.shape[:-1] + (C_OUT,)).astype(np.float32)
    jm = JaxFusedBottleneck(C_OUT, interpret=True)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias),
              "kernel": jnp.asarray(kernel)}
    bs = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
    want, want_bs, (gp, gx) = _jax_run(
        jm, params, bs, x, None if mask is None else jnp.asarray(mask), r,
        train, lambda m, v, xx, mk, **kw: m.apply(v, xx, train, mk, **kw))

    fb = FusedBottleneck(C_IN, C_OUT)
    with torch.no_grad():
        for t, v in zip((fb.scale, fb.bias, fb.kernel, fb.mean, fb.var),
                        (scale, bias, kernel, mean, var)):
            t.copy_(torch.from_numpy(v))
    out, dx = _port_run(fb, x, mask, r, train)
    np.testing.assert_allclose(_from_port(out), np.asarray(want), **TOL)
    np.testing.assert_allclose(fb.mean.numpy(), np.asarray(want_bs["mean"]),
                               **TOL)
    np.testing.assert_allclose(fb.var.numpy(), np.asarray(want_bs["var"]),
                               **TOL)
    for name, got, want_g in (("x", _from_port(dx), gx),
                              ("scale", fb.scale.grad.numpy(), gp["scale"]),
                              ("bias", fb.bias.grad.numpy(), gp["bias"]),
                              ("kernel", fb.kernel.grad.numpy(), gp["kernel"])):
        scale_g = max(1.0, float(np.abs(want_g).max()))
        np.testing.assert_allclose(got, np.asarray(want_g), rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale_g, err_msg=name)


def test_negative_variance_is_clamped():
    """The input of the negative-variance case does round E[x^2] - mean^2
    below zero, and the statistics clamp it to 0 (unbiased too)."""
    x, *_ = _case_inputs("train-negative-var")
    t = torch.from_numpy(x)
    raw = t.square().mean(0) - t.mean(0).square()
    assert (raw < 0).any()
    _, var, unbiased, _ = compute_batch_stats(t)
    assert (var >= 0).all() and (unbiased >= 0).all()
    assert (var[raw < 0] == 0).all()


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_statistics(p):
    """Elementwise dropout: rate p within 4 sigma, survivors scaled by
    1 / (1 - p), a generator makes it repeatable; eval mode and p = 0 are
    the identity."""
    x = torch.rand(200, 1000) + 0.5
    d = Dropout(p).train()
    y = d(x, torch.Generator().manual_seed(0))
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - p) <= 4 * (p * (1 - p) / x.numel()) ** 0.5
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    assert torch.equal(y, d(x, torch.Generator().manual_seed(0)))
    assert d.eval()(x) is x and Dropout(0.0).train()(x) is x


def test_channel_dropout_statistics():
    """Dropout3d: each (sample, channel) is dropped whole, at rate p
    within 4 sigma, the rest scaled by 1 / (1 - p); the output keeps the
    channels-last layout."""
    p = 0.2
    x = (torch.rand(40, 100, 3, 3, 3) + 0.5).contiguous(
        memory_format=torch.channels_last_3d)
    y = Dropout(p, channels=True).train()(
        x, torch.Generator().manual_seed(1))
    zero = (y == 0).flatten(2)
    whole = zero.all(-1)
    assert torch.equal(zero.any(-1), whole)  # never part of a channel
    rate = whole.float().mean().item()
    assert abs(rate - p) <= 4 * (p * (1 - p) / whole.numel()) ** 0.5
    torch.testing.assert_close(y[y != 0], x[y != 0] / (1 - p))
    assert y.is_contiguous(memory_format=torch.channels_last_3d)


def test_mlp_dropout_is_elementwise_after_bn():
    """The MLP's stage order is Dense -> BN -> Dropout -> ReLU: in train
    mode a stage hands on relu(bn * keep / (1 - p)), with about half of the
    positive BN outputs dropped at p = 0.5."""
    m = MLP(in_channels=11, out_channels=None, feature_channels=12,
            dropout_prob=0.5).train()
    x = torch.randn(512, 11)
    seen = []
    m.bn_1.register_forward_hook(lambda mod, i, o: seen.append(o))
    m.dense_2.register_forward_pre_hook(lambda mod, i: seen.append(i[0]))
    m(x, return_features=True, generator=torch.Generator().manual_seed(2))
    bn_out, next_in = seen
    zero = next_in == 0
    assert zero[bn_out <= 0].all()  # the ReLU comes after the dropout
    dropped = zero[bn_out > 0].float().mean().item()
    assert abs(dropped - 0.5) <= 4 * (0.25 / (bn_out > 0).sum().item()) ** 0.5
    torch.testing.assert_close(next_in[~zero], 2 * bn_out[~zero])


def test_init_follows_the_jax_rules():
    """Every DenseNet121 convolution (bottleneck kernels included) draws
    N(0, 2 / fan_in) and every dense kernel flax's lecun-normal (truncated
    at 2 sigma, variance 1 / fan_in), zero biases, BN scale 1 and bias 0:
    each layer of >= 10k weights within 3 % of its std."""
    torch.manual_seed(0)
    model = densenet121(in_channels=2, out_channels=2, feature_channels=12)
    checked = 0
    for name, p in model.named_parameters():
        w = p.detach()
        if name.endswith("fused1.kernel"):
            fan_in, rule = w.shape[0], 2.0
        elif w.dim() == 5:
            fan_in, rule = w[0].numel(), 2.0
        elif w.dim() == 2:
            fan_in, rule = w.shape[1], 1.0
            assert w.abs().max() <= 2 * (1.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
        else:
            ones = name.endswith(".scale") or (
                name.endswith(".weight") and "norm" in name)
            assert torch.equal(w, torch.ones_like(w) if ones
                               else torch.zeros_like(w)), name
            continue
        if w.numel() >= 10_000:
            assert abs(w.std().item() / (rule / fan_in) ** 0.5 - 1) < 0.03, name
            assert abs(w.mean().item()) < 0.03 * (rule / fan_in) ** 0.5, name
            checked += 1
    assert checked >= 100
