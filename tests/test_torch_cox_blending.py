"""mmnn_sts_torch.ops.{cox, blending, metrics} against the JAX package's
ops/cox.py, ops/blending.py and ops/metrics.py: Breslow and Efron Cox
losses and their gradients on batches with tied durations, ragged masks and
an all-masked batch; the blended survival loss; both sign conventions of the
blend update; the host C-index. Tolerance rtol/atol 1e-5 for losses and
gradients (float32, other summation orders); C-indices exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.ops import blending as jblend
from mmnn_sts_tpu.ops import cox as jcox
from mmnn_sts_tpu.ops import metrics as jmetrics
from mmnn_sts_torch.ops import blending, cox, metrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N, C, K = 12, 2, 3


def _batch(seed, mask_kind):
    """log hazards (K, N, C), events and durations (N, C) with ties (small
    integer durations), and a (N,) mask."""
    rng = np.random.default_rng(seed)
    preds = rng.normal(0.0, 1.5, (K, N, C)).astype(np.float32)
    events = (rng.random((N, C)) < 0.6).astype(np.float32)
    durations = rng.integers(1, 5, (N, C)).astype(np.float32)
    mask = {"none": None,
            "ragged": (np.arange(N) < N - 5).astype(np.float32),
            "all-masked": np.zeros(N, np.float32)}[mask_kind]
    if mask is not None:  # masked rows may hold anything, even overflow
        preds[:, mask == 0] = rng.choice([1e30, -1e30, 50.0],
                                         (K, int((mask == 0).sum()), C))
    return preds, events, durations, mask


def _opt(a, lib):
    return None if a is None else (jnp.asarray(a) if lib == "jax"
                                   else torch.from_numpy(a))


@pytest.mark.parametrize("ties", ["breslow", "efron"])
@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all-masked"])
def test_multi_cox_loss_and_grad_match_jax(ties, mask_kind):
    preds, events, durations, mask = _batch(7, mask_kind)
    lh = preds[0]
    want, want_g = jax.value_and_grad(
        lambda p: jcox.multi_cox_loss(p, jnp.asarray(events),
                                      jnp.asarray(durations), ties=ties,
                                      mask=_opt(mask, "jax")))(jnp.asarray(lh))
    t = torch.from_numpy(lh).requires_grad_()
    got = cox.multi_cox_loss(t, torch.from_numpy(events),
                             torch.from_numpy(durations), ties=ties,
                             mask=_opt(mask, "torch"))
    got.backward()
    assert torch.isfinite(got) and torch.isfinite(t.grad).all()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), **TOL)
    if mask_kind == "all-masked":
        assert got.item() == 0.0 and not t.grad.any()


@pytest.mark.parametrize("fn", ["cox_ph_loss", "cox_ph_loss_efron"])
def test_single_column_losses_match_jax(fn):
    """One (N,) column, every sample tied with another."""
    rng = np.random.default_rng(3)
    lh = rng.normal(size=N).astype(np.float32)
    events = np.tile([1.0, 0.0, 1.0], N // 3).astype(np.float32)
    durations = np.repeat(np.arange(N // 2), 2)[::-1].astype(np.float32)
    want = getattr(jcox, fn)(*(jnp.asarray(a) for a in (lh, events,
                                                       durations)))
    got = getattr(cox, fn)(*(torch.from_numpy(a) for a in (lh, events,
                                                           durations)))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_efron_differs_from_breslow_only_with_tied_events():
    rng = np.random.default_rng(4)
    lh = torch.from_numpy(rng.normal(size=(N, 1)).astype(np.float32))
    events = torch.ones(N, 1)
    distinct = torch.arange(N, dtype=torch.float32)[:, None]
    tied = distinct // 3
    same = [cox.multi_cox_loss(lh, events, distinct, ties=t).item()
            for t in ("breslow", "efron")]
    assert same[0] == pytest.approx(same[1], rel=1e-6)
    assert abs(cox.multi_cox_loss(lh, events, tied, ties="efron").item()
               - cox.multi_cox_loss(lh, events, tied, ties="breslow").item()
               ) > 1e-2


@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_blended_surv_loss_matches_jax(mask_kind):
    """Weighted per-head losses, the selection loss (head 0's own), and a
    gradient that does not reach the blend weights."""
    preds, events, durations, mask = _batch(11, mask_kind)
    weights = np.asarray([0.5, 0.3, 0.2], np.float32)
    jstate = jblend.blend_init(K).replace(weights=jnp.asarray(weights))
    (want, want_sel), want_g = jax.value_and_grad(
        lambda p: jblend.blended_surv_loss(
            jstate, p, jnp.asarray(events), jnp.asarray(durations),
            mask=_opt(mask, "jax")), has_aux=True)(jnp.asarray(preds))
    state = blending.blend_init(K)
    state.weights = torch.from_numpy(weights).requires_grad_()
    p = torch.from_numpy(preds).requires_grad_()
    got, sel = blending.blended_surv_loss(
        state, p, torch.from_numpy(events), torch.from_numpy(durations),
        mask=_opt(mask, "torch"))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(sel.item(), float(want_sel), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)
    assert state.weights.grad is None
    heads = blending.surv_head_losses(p, torch.from_numpy(events),
                                      torch.from_numpy(durations))
    want_heads = jblend.surv_head_losses(
        jnp.asarray(preds), jnp.asarray(events), jnp.asarray(durations))
    np.testing.assert_allclose(heads.detach().numpy(), np.asarray(want_heads),
                               **TOL)


@pytest.mark.parametrize("survival", [True, False])
def test_blend_update_matches_jax(survival):
    """Two updates (the first gives uniform weights, the second the
    softmax of dG / dO^2 in the survival or the classification sign
    convention); the weights sum to 1."""
    rng = np.random.default_rng(5 + survival)
    losses = rng.uniform(1.0, 3.0, (2, 2, K)).astype(np.float32)
    jstate, state = jblend.blend_init(K), blending.blend_init(K)
    for train_loss, val_loss in losses:
        jstate = jblend.blend_update(jstate, jnp.asarray(train_loss),
                                     jnp.asarray(val_loss), survival)
        state = blending.blend_update(state, torch.from_numpy(train_loss),
                                      torch.from_numpy(val_loss), survival)
        np.testing.assert_allclose(state.weights.numpy(),
                                   np.asarray(jstate.weights), **TOL)
        assert state.weights.sum().item() == pytest.approx(1.0, abs=1e-6)
    assert not np.allclose(state.weights.numpy(), 1.0 / K)
    np.testing.assert_array_equal(state.lvn.numpy(), losses[-1, 1])
    np.testing.assert_array_equal(state.ltn.numpy(), losses[-1, 0])


def test_blend_sign_conventions_differ():
    state = blending.blend_update(blending.blend_init(K), torch.ones(K),
                                  torch.full((K,), 2.0), True)
    train_loss = torch.tensor([1.0, 1.2, 0.8])
    val_loss = torch.tensor([1.5, 2.5, 1.9])
    surv = blending.blend_update(state, train_loss, val_loss, True).weights
    cls = blending.blend_update(state, train_loss, val_loss, False).weights
    assert torch.argmax(surv) != torch.argmax(cls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_c_indices_per_class_equal_jax(seed):
    """Ties in durations and in predictions, censored pairs at equal
    times: the same C-indices as the JAX package's host C-index."""
    rng = np.random.default_rng(seed)
    n = 40
    preds = np.round(rng.normal(size=(n, C)), 1)
    events = (rng.random((n, C)) < 0.5).astype(np.float32)
    durations = rng.integers(1, 10, (n, C)).astype(np.float32)
    got = metrics.c_indices_per_class(preds, events, durations)
    assert got == jmetrics.c_indices_per_class(preds, events, durations)
    with pytest.raises(ZeroDivisionError):
        metrics.concordance_index([1.0, 2.0], [0.1, 0.2], [0, 0])
