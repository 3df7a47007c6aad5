"""The port's survival training slice as a whole, held against the JAX
package's: one ``survival_train_superstep`` (A = 2 microbatches of B = 4,
``augment=False``, ``blend=True``) from the same weights and batch in both
packages, without a mask (Breslow ties) and with a ragged mask (Efron
ties), then ``survival_eval_step``.

The model is a narrow multimodal blend model: TinyDenseNet (blocks 6, 12, 4;
growth 8, 16 initial features, bottleneck width 16) at 16^3 x 2ch plus the
11-input clinical MLP, dropout 0 on both sides. The JAX side is built
directly with ``use_pallas=True, pallas_interpret=True`` (the registry never
sets interpret mode), so its bottlenecks run the Pallas kernel in interpret
mode with their custom VJP. The JAX superstep donates its state, so the
weights are copied to numpy before the call.

Compared: the summed loss, the predictions (A, K, B, C) and every
BatchNorm statistic after the update, rtol/atol 1e-4; the update of every
parameter (new - old, the optimizer's effect at a step-0 learning rate of
0.1) in relative L2, within 3e-2 for each tensor and 1e-2 for all together.
The update cannot be held elementwise: scaling the input image by
1 + 2^-22 moves the JAX superstep's own update by 2e-2 (no mask) and 6e-2
(ragged) in relative L2 over all parameters and by up to 6e-2 and 3.4e-1 in
one tensor (ReLUs and max pools flip at roundoff, BatchNorm runs over as
few as 4 values); the port lies 6e-4 and 5e-3 from it, 1e-2 at most in one
tensor. The eval step runs on the weights the JAX superstep left, since
eval-mode BatchNorm on running statistics amplifies the two updates'
roundoff as well.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_tpu.train.steps import survival_eval_step as jax_eval_step
from mmnn_sts_tpu.train.steps import survival_train_superstep as jax_superstep
from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
from mmnn_sts_torch.models.densenet import tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    survival_eval_step, survival_train_superstep)
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
UPDATE_TOL, UPDATE_TOL_ALL = 3e-2, 1e-2
A, B, SIDE, P = 2, 4, 16, 11
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
LR, STEPS_PER_EPOCH, EPOCHS = 2.5, 2, 3  # step-0 learning rate 2.5 / 25
CASES = {"breslow": None, "efron-ragged": [[1, 1, 1, 1], [1, 1, 0, 0]]}


def _batch(seed, lead):
    rng = np.random.default_rng(seed)
    inputs = {"image": (rng.normal(size=lead + (SIDE,) * 3 + (2,)) ** 2
                        * 500).astype(np.float32),
              "clinical": rng.normal(size=lead + (P,)).astype(np.float32)}
    events = (rng.random(lead + (2,)) < 0.7).astype(np.float32)
    durations = rng.integers(1, 4, lead + (2,)).astype(np.float32)  # ties
    return inputs, events, durations


def _jax_state():
    image = jax_tiny_densenet(**TINY, out_channels=2, dropout_prob=0.0,
                              use_pallas=True, pallas_interpret=True)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=P,
                          num_classes=2, num_features=4, blend=True,
                          clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((B,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((B, P))}
    state = jax_create_state(
        model, jax_make_optimizer(LR, STEPS_PER_EPOCH, EPOCHS), sample,
        seed=0)
    flat = randomise(jax_flat({"params": state.params,
                               "batch_stats": state.batch_stats}), seed=3)
    variables = jax_variables(flat)
    return state.replace(params=variables["params"],
                         batch_stats=variables["batch_stats"]), flat


def _port_state(flat):
    encoder = tiny_densenet(**TINY, out_channels=None, dropout_prob=0.0)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=0.0)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), LR, STEPS_PER_EPOCH,
                                EPOCHS)
    return create_train_state(model, opt, sched, seed=0)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def run_superstep(case):
    """Both packages' superstep and eval step from the same weights:
    (weights before, the JAX results, the port's results)."""
    ties = case.split("-")[0]
    mask = None if CASES[case] is None else np.asarray(CASES[case],
                                                       np.float32)
    jstate, before = _jax_state()
    inputs, events, durations = _batch(1, (A, B))
    jnew, jaux = jax_superstep(
        jstate, {k: jnp.asarray(v) for k, v in inputs.items()},
        jnp.asarray(events), jnp.asarray(durations), jax.random.key(0),
        blend=True, augment=False, ties=ties,
        mask=None if mask is None else jnp.asarray(mask))
    jax_after = jax_flat({"params": jnew.params,
                          "batch_stats": jnew.batch_stats})
    val = _batch(2, (B,))
    jval = jax_eval_step(jnew, {k: jnp.asarray(v) for k, v in val[0].items()},
                         jnp.asarray(val[1]), jnp.asarray(val[2]), blend=True,
                         ties=ties)
    want = dict(loss=float(jaux["loss"]), preds=np.asarray(jaux["preds"]),
                step=int(jnew.step), after=jax_after,
                val={k: np.asarray(v) for k, v in jval.items()})

    state = _port_state(before)
    aux = survival_train_superstep(
        state, _torch(inputs), _torch(events), _torch(durations), blend=True,
        augment=False, ties=ties, mask=_torch(mask))
    port_after = to_jax_flat(state.model.state_dict(), layout="fused")
    # the eval step on the weights the JAX superstep left: eval-mode BN on
    # running statistics amplifies the two updates' last-bit differences
    val_state = _port_state(jax_after)
    pval = survival_eval_step(val_state, _torch(val[0]), _torch(val[1]),
                              _torch(val[2]), blend=True, ties=ties)
    got = dict(loss=aux["loss"].item(), preds=aux["preds"].numpy(),
               step=state.step, after=port_after,
               val={k: v.numpy() for k, v in pval.items()}, state=state,
               val_state=val_state)
    return before, want, got


@pytest.fixture(scope="module", params=list(CASES))
def superstep(request):
    return run_superstep(request.param)


def test_superstep_loss_and_preds_match_jax(superstep):
    _, want, got = superstep
    assert got["step"] == want["step"] == 1
    assert got["preds"].shape == want["preds"].shape == (A, 3, B, 2)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["preds"], want["preds"], **TOL)


def test_superstep_update_matches_jax(superstep):
    """Every BatchNorm statistic after the microbatches' running-stat
    updates, elementwise; every parameter's update (new - old: the summed
    gradient through SGD-nesterov with decay at the schedule's step-0 rate)
    in relative L2, each tensor and all together."""
    before, want, got = superstep
    assert sorted(got["after"]) == sorted(want["after"]) == sorted(before)
    deltas_p, deltas_j = [], []
    for key, old in before.items():
        new_p, new_j = got["after"][key], np.asarray(want["after"][key])
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(new_p, new_j, **TOL, err_msg=key)
            continue
        delta_p, delta_j = new_p - old, new_j - old
        err = np.linalg.norm(delta_p - delta_j) / np.linalg.norm(delta_j)
        assert err <= UPDATE_TOL, (key, err)
        deltas_p.append(delta_p.ravel())
        deltas_j.append(delta_j.ravel())
    delta_p, delta_j = np.concatenate(deltas_p), np.concatenate(deltas_j)
    err = np.linalg.norm(delta_p - delta_j) / np.linalg.norm(delta_j)
    assert err <= UPDATE_TOL_ALL, err


def test_eval_step_matches_jax(superstep):
    _, want, got = superstep
    for key in ("loss", "selection_loss", "preds"):
        np.testing.assert_allclose(got["val"][key], want["val"][key], **TOL,
                                   err_msg=key)
    assert not got["val_state"].model.training


def test_superstep_leaves_summed_gradients_finite(superstep):
    state = superstep[2]["state"]
    grads = [p.grad for p in state.model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_train_path_runs_without_jax():
    """Importing the train path and running a superstep, an eval step and a
    blend update on the CPU loads neither jax nor the JAX package (a
    subprocess: this pytest process imports jax)."""
    script = (
        "import sys, torch\n"
        "from mmnn_sts_torch.config import Config\n"
        "from mmnn_sts_torch.models import build_model\n"
        "from mmnn_sts_torch.ops.blending import blend_update\n"
        "from mmnn_sts_torch.ops.metrics import c_indices_per_class\n"
        "from mmnn_sts_torch.train.schedule import make_optimizer\n"
        "from mmnn_sts_torch.train.state import create_train_state\n"
        "from mmnn_sts_torch.train.steps import (survival_eval_step,\n"
        "    survival_train_superstep)\n"
        "torch.manual_seed(0)\n"
        "cfg = Config()\n"
        "cfg.image_model.name = 'tinydensenet'\n"
        "model = build_model(cfg, images=True, preop=True, postop=False,\n"
        "                    blend=True)\n"
        "state = create_train_state(model, *make_optimizer(\n"
        "    model.parameters(), 1e-2, 1, 4), seed=0)\n"
        "x = {'image': torch.rand(2, 2, 16, 16, 16, 2) * 500,\n"
        "     'clinical': torch.randn(2, 2, 11)}\n"
        "e = torch.tensor([[[1., 0.], [1., 1.]], [[0., 1.], [1., 1.]]])\n"
        "d = torch.tensor([[[3., 2.], [1., 2.]], [[2., 2.], [4., 1.]]])\n"
        "aux = survival_train_superstep(state, x, e, d, blend=True,\n"
        "                               augment=False)\n"
        "assert aux['preds'].shape == (2, 3, 2, 2), aux['preds'].shape\n"
        "assert torch.isfinite(aux['loss']) and state.step == 1\n"
        "ev = survival_eval_step(state, {k: v[0] for k, v in x.items()},\n"
        "                        e[0], d[0], blend=True)\n"
        "c = c_indices_per_class(ev['preds'][0].numpy(), e[0].numpy(),\n"
        "                        d[0].numpy())\n"
        "state.blend = blend_update(state.blend, torch.ones(3),\n"
        "                           torch.full((3,), 2.0), survival=True)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')\n"
        "             or k.startswith('mmnn_sts_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
