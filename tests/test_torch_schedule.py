"""mmnn_sts_torch.train.schedule against the JAX package's
train/schedule.py (optax): the OneCycle learning rate at every step of
runs of 1 to 20 total steps (under 4 the JAX package's guard stretches the
schedule to 4 steps), and SGD with nesterov momentum and weight decay over
six updates with that schedule. Tolerances: rtol 1e-5 on the learning rate
(float32 on both sides, cos from two libraries); rtol/atol 1e-6 on the
parameters.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmnn_sts_tpu.train import schedule as jschedule
from mmnn_sts_torch.train import schedule

torch.set_num_threads(1)


@pytest.mark.parametrize("total", range(1, 21))
def test_onecycle_matches_optax(total):
    want = jschedule.onecycle(0.3, total, 1)
    got = schedule.onecycle(0.3, total, 1)
    for step in range(max(total, 4) + 3):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert np.isfinite(w)
        assert got(step) == pytest.approx(w, rel=1e-5, abs=1e-12), step


def test_onecycle_is_not_torchs_onecyclelr():
    """torch's OneCycleLR puts its peak at another step than optax."""
    total = 10
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, 1.0, total_steps=total)
    theirs = []
    for _ in range(total):
        theirs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    ours = [schedule.onecycle(1.0, total, 1)(s) for s in range(total)]
    assert np.argmax(ours) == 3 and np.argmax(theirs) != np.argmax(ours)


def test_sgd_nesterov_with_decay_matches_optax():
    """Six updates of two parameters with gradients that depend on the
    parameters: the same trajectory as optax's add_decayed_weights + sgd
    (nesterov) at the OneCycle learning rate."""
    rng = np.random.default_rng(0)
    init = [rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=(3,)).astype(np.float32)]
    targets = [rng.normal(size=a.shape).astype(np.float32) for a in init]

    def grads(params, lib):  # a bounded gradient field, plus a linear pull
        return [lib.tanh(p - lib.asarray(t)) + 0.1 * p
                for p, t in zip(params, targets)]

    tx = jschedule.make_optimizer(0.5, 3, 2)
    jparams = [jnp.asarray(a) for a in init]
    opt_state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = schedule.make_optimizer(params, 0.5, 3, 2)
    for step in range(6):
        updates, opt_state = tx.update(grads(jparams, jnp), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads([p.detach() for p in params], torch)):
            p.grad = g.clone()
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=1e-6, atol=1e-6)
    assert not np.allclose(params[0].detach().numpy(), init[0])


def test_steps_per_epoch_ceil():
    assert [schedule.steps_per_epoch(n, 64) for n in (1, 63, 64, 65, 128)] \
        == [jschedule.steps_per_epoch(n, 64) for n in (1, 63, 64, 65, 128)] \
        == [1, 1, 1, 2, 2]
