"""bfloat16 compute in the port's steps, held against the JAX package's
bfloat16 path on the CPU: the multimodal blend model in train mode (one
``survival_train_superstep``, A = 2 microbatches of B = 4, ``augment=False``:
its predictions, loss, update and running statistics) and in eval mode
(``survival_eval_step``: predictions and losses), one
``classification_train_step`` (logits, loss, update), and Grad-CAM's
``attention_maps``.

The model is a narrow two-block DenseNet (blocks 2, 2; growth 8, 16 initial
features, bottleneck width 16; its last block is 2^3 at 16^3, so Grad-CAM
has a map) with the 11-input clinical MLP and blend heads, dropout 0, in
bfloat16 on both sides; the weights are drawn with numpy and carried across
by ``convert.py``. The JAX steps are the package's own jitted functions,
the reference compiled without excess precision, the control (the unfused
bottleneck) as the package compiles it (tests/test_torch_bf16.py,
``call``). Each result is held to that file's rules
(``check_against_jax``); the update is new - old over all parameters.
Grad-CAM is not held within half the float32 distance: JAX normalises and
resizes its maps in bfloat16, the port in float32 (a deliberate
difference), so the reference's own last roundings are in that distance.

Measured (CPU; port / control / float32 distance): superstep predictions
2.6e-3 / 4.6e-2 / 3.9e-2, loss 3.6e-4 / 1.1e-2 / 7.8e-3, update 8.1e-3 /
0.62 / 0.50, running statistics 1.1e-4 / 6.6e-4 / 6.3e-4; eval step
predictions 0 / 2.7e-3 / 3.8e-3; classification logits 0 / 9.8e-3 /
8.6e-3, update 1.0e-3 / 7.7e-2 / 8.8e-2; Grad-CAM maps 2.6e-3 / 3.3e-3 /
4.3e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.ops.augment import eval_transform as jax_eval_transform
from mmnn_sts_tpu.ops.blending import blend_init as jax_blend_init
from mmnn_sts_tpu.ops.gradcam import attention_maps as jax_attention_maps
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import TrainState as JaxTrainState
from mmnn_sts_tpu.train.steps import (
    classification_train_step as jax_class_step)
from mmnn_sts_tpu.train.steps import survival_eval_step as jax_eval_step
from mmnn_sts_tpu.train.steps import survival_train_superstep as jax_superstep
from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops.gradcam import attention_maps
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    classification_train_step, survival_eval_step, survival_train_superstep)
from test_torch_bf16 import (
    PATHS, assert_bf16, bf16_at_cast_points, call, check_against_jax)
from test_torch_convert import jax_variables, randomise

torch.set_num_threads(1)

A, B, SIDE, P, C = 2, 4, 16, 11, 2
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2, dropout_prob=0.0)
LR, STEPS_PER_EPOCH, EPOCHS = 2.5, 2, 3  # step-0 learning rate 2.5 / 25
POS_WEIGHT = np.array([1.5, 0.8], np.float32)


def _port_model(flat):
    model = MultiModalModel(
        DenseNet(**NARROW, out_channels=None, dtype=torch.bfloat16), P,
        num_classes=C, num_features=4, blend=True, clinical_dropout_prob=0.0,
        dtype=torch.bfloat16)
    if flat is not None:
        load_jax_npz(model, flat)
    return model


@pytest.fixture(scope="module")
def weights():
    """Numpy-drawn weights in both JAX bottleneck layouts."""
    torch.manual_seed(2)
    model = _port_model(None)
    fused = randomise(to_jax_flat(model.state_dict(), layout="fused"), seed=8)
    load_jax_npz(model, fused)
    return {True: fused,
            False: to_jax_flat(model.state_dict(), layout="unfused")}


def _jax_model(path):
    dtype, fused = PATHS[path]
    image = JaxDenseNet(**NARROW, out_channels=C, dtype=dtype,
                        use_pallas=fused, pallas_interpret=fused)
    return JaxMultiModal(image_model=image, num_clinical_inputs=P,
                         num_classes=C, num_features=4, blend=True,
                         clinical_dropout_prob=0.0, dtype=dtype)


def _jax_state(path, weights):
    variables = jax_variables(weights[PATHS[path][1]])
    tx = jax_make_optimizer(LR, STEPS_PER_EPOCH, EPOCHS)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), blend=jax_blend_init(3),
        rng=jax.random.key(0), apply_fn=_jax_model(path).apply, tx=tx)


def _port_state(weights):
    model = _port_model(weights[True])
    opt, sched = make_optimizer(model.parameters(), LR, STEPS_PER_EPOCH,
                                EPOCHS)
    return create_train_state(model, opt, sched, seed=0)


def _batch(seed, lead):
    rng = np.random.default_rng(seed)
    inputs = {"image": (rng.normal(size=lead + (SIDE,) * 3 + (2,)) ** 2
                        * 500).astype(np.float32),
              "clinical": rng.normal(size=lead + (P,)).astype(np.float32)}
    events = (rng.random(lead + (C,)) < 0.7).astype(np.float32)
    durations = rng.integers(1, 4, lead + (C,)).astype(np.float32)  # ties
    return inputs, events, durations


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _update(after, before):
    """new - old of every parameter, in the flat key layout."""
    return {k: np.asarray(after[k], np.float64) - np.asarray(v, np.float64)
            for k, v in before.items() if k.startswith("params/")}


def _stats(flat):
    return {k: np.asarray(v) for k, v in flat.items()
            if k.startswith("batch_stats/")}


def _jax_flat(state, path):
    """A JAX state's weights in the fused flat layout."""
    from test_torch_convert import jax_flat

    flat = jax_flat({"params": state.params,
                     "batch_stats": state.batch_stats})
    model = _port_model(None)
    load_jax_npz(model, flat)
    return to_jax_flat(model.state_dict(), layout="fused")


@pytest.fixture(scope="module")
def superstep(weights):
    """The superstep in every JAX path and in the port: {path: (aux, the
    weights after, in the fused flat layout)}, and the port's cast-point
    dtypes."""
    inputs, events, durations = _batch(1, (A, B))
    out = {}
    for path in PATHS:
        new, aux = call(path, jax_superstep, _jax_state(path, weights),
                         _jnp(inputs), jnp.asarray(events),
                         jnp.asarray(durations), jax.random.key(0),
                         blend=True, augment=False)
        out[path] = ({k: np.asarray(v, np.float32) for k, v in aux.items()},
                     _jax_flat(new, path))
    state = _port_state(weights)
    seen = bf16_at_cast_points(state.model)
    aux = survival_train_superstep(state, _torch(inputs), _torch(events),
                                   _torch(durations), blend=True,
                                   augment=False)
    out["port"] = ({k: v.float().numpy() for k, v in aux.items()},
                   to_jax_flat(state.model.state_dict(), layout="fused"))
    return out, seen


def test_superstep_in_bf16_train_forward(superstep):
    """The multimodal model in train mode: the superstep's predictions
    (A, K, B, C) and its summed loss."""
    out, seen = superstep
    assert_bf16(seen)
    check_against_jax("superstep predictions (train forward)",
                      out["port"][0]["preds"],
                      {p: out[p][0]["preds"] for p in PATHS})
    check_against_jax("superstep loss", out["port"][0]["loss"],
                      {p: out[p][0]["loss"] for p in PATHS})


def test_superstep_in_bf16_update(superstep, weights):
    """The parameters' update (new - old) over all parameters, and the
    running statistics after it."""
    out, _ = superstep
    before = weights[True]
    check_against_jax("superstep update", _update(out["port"][1], before),
                      {p: _update(out[p][1], before) for p in PATHS})
    check_against_jax("superstep running statistics",
                      _stats(out["port"][1]),
                      {p: _stats(out[p][1]) for p in PATHS})


def test_eval_step_in_bf16(weights):
    """The multimodal model in eval mode: ``survival_eval_step``'s
    predictions (K, B, C) and its losses."""
    inputs, events, durations = _batch(2, (B,))
    want = {}
    for path in PATHS:
        res = call(path, jax_eval_step, _jax_state(path, weights), _jnp(inputs),
                    jnp.asarray(events), jnp.asarray(durations), blend=True)
        want[path] = {k: np.asarray(v, np.float32) for k, v in res.items()}
    state = _port_state(weights)
    seen = bf16_at_cast_points(state.model)
    got = survival_eval_step(state, _torch(inputs), _torch(events),
                             _torch(durations), blend=True)
    assert got["preds"].dtype == torch.bfloat16
    assert got["loss"].dtype == torch.float32
    assert_bf16(seen)
    check_against_jax("eval step predictions (eval forward)",
                      got["preds"].float(),
                      {p: want[p]["preds"] for p in PATHS})
    check_against_jax("eval step losses",
                      [got["loss"], got["selection_loss"]],
                      {p: [want[p]["loss"], want[p]["selection_loss"]]
                       for p in PATHS})


def test_classification_step_in_bf16(weights):
    """One classification step on a batch of B: logits, loss, update."""
    inputs, labels, _ = _batch(3, (B,))
    want = {}
    for path in PATHS:
        new, aux = call(path, jax_class_step, _jax_state(path, weights),
                         _jnp(inputs), jnp.asarray(labels),
                         jnp.asarray(POS_WEIGHT), jax.random.key(0),
                         blend=True, augment=False)
        want[path] = (np.asarray(aux["preds"], np.float32),
                      float(aux["loss"]), _jax_flat(new, path))
    state = _port_state(weights)
    seen = bf16_at_cast_points(state.model)
    aux = classification_train_step(state, _torch(inputs), _torch(labels),
                                    torch.from_numpy(POS_WEIGHT), blend=True,
                                    augment=False)
    assert aux["preds"].dtype == torch.bfloat16
    assert_bf16(seen)
    after = to_jax_flat(state.model.state_dict(), layout="fused")
    check_against_jax("classification step logits",
                      aux["preds"].float(), {p: want[p][0] for p in PATHS})
    check_against_jax("classification step loss", aux["loss"],
                      {p: want[p][1] for p in PATHS})
    before = weights[True]
    check_against_jax("classification step update", _update(after, before),
                      {p: _update(want[p][2], before) for p in PATHS})


def test_gradcam_in_bf16(weights):
    """``attention_maps`` of one eval-transformed patient: float32 maps from
    the bfloat16 activation and gradient."""
    inputs, _, _ = _batch(4, (1,))
    inputs["image"] = np.asarray(jax.vmap(jax_eval_transform)(
        jnp.asarray(inputs["image"])))
    want = {}
    for path in PATHS:
        variables = jax_variables(weights[PATHS[path][1]])
        maps = jax.jit(lambda v, x, apply=_jax_model(path).apply:
                       jax_attention_maps(apply, v, x, C, blend=True))
        want[path] = np.asarray(call(path, maps, variables, _jnp(inputs)),
                                np.float32)
    model = _port_model(weights[True]).eval()
    seen = bf16_at_cast_points(model)
    got = attention_maps(model, _torch(inputs), C, blend=True)
    assert got.dtype == torch.float32 and got.shape == (C,) + (SIDE,) * 3
    assert_bf16(seen)
    # JAX normalises and resizes the maps in bfloat16, the port in float32:
    # JAX's last roundings are part of its own distance to float32
    check_against_jax("Grad-CAM maps", got, want, within_half=False)
