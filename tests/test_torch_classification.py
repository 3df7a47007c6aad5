"""The port's classification path held against the JAX package's: the
losses (``ops/losses.py``), F1 and confusion counts (``ops/metrics.py``),
the classification half of ``ops/blending.py``, one
``classification_train_step``, ``classification_eval_split``, a 3-epoch
``train_classification`` twin, and the port's ``model.npz`` in the JAX
model.

**Step.** A narrow TinyDenseNet blend model (blocks 6, 12, 4; growth 8, 16
initial features, bottleneck width 16) at 16^3 x 2ch with the 11-input
clinical MLP, dropout 0, B = 4 with the last sample masked (a ragged
tail), ``augment=False``, pos_weight from label frequencies; the JAX side
runs the Pallas bottleneck in interpret mode (the port's fused op's
semantics on masked rows). Loss and logits within 1e-5 relative; the
parameters' update (new - old at the schedule's step-0 rate) in relative
L2 over all parameters, within 3 x a control's distance: the JAX step
with its image and clinical inputs scaled by 1 + 2^-22 (roundoff flips
ReLUs and max pools, and the image's scale of ~500 makes conv0's gradient
jump; see tests/test_torch_train_steps.py), measured in the test; and
below 0.25, since an update at half the rate reads 0.5 and none 1.0.
Measured (CPU): control 0.12, port 0.012.

**Loop twin.** ``train_classification`` in both packages on one cohort
(36 patients of ``tests/fixtures.make_full_cohort`` at 16^3, ``--split``
seed 42: 23 train, 6 validation), from the same weights (a narrow
two-block DenseNet blend model; the JAX side's unfused bottleneck, the JAX
CLI's default), dropout 0, ``augment=False``, batch 4 (6 steps an epoch,
the last ragged), a blend update every epoch, OneCycle peak 2e-4, 3
epochs. The loop amplifies roundoff (ROADMAP.md Queue 3): a ReLU that
flips in the clinical MLP, whose inputs run to the hundreds, moves the
first layer's gradient by half its size. So it is held against two
controls, the JAX loop with its inputs scaled by 1 + 2^-22 and by
1 - 2^-22. Per epoch, the port's train and validation losses and its
blend weights lie within 3 x the controls' larger relative distance from
the JAX run (or 1e-4), wherever both controls moved less than 1e-3, so
that every limit lies under 1e-2; the first epoch's losses are always
compared. F1s and the best epoch are compared where both controls kept
them. Measured (CPU): the controls moved the train losses by at most
2.8e-6, 1.2e-4 and 7.5e-4 an epoch and the validation losses by 4.9e-5,
1.4e-3 (not compared) and 3.2e-5; the port lay 1.6e-6, 3.0e-5, 6.2e-6
and 3.1e-5, 1.1e-3, 7.0e-5 from JAX. The last blend row (the update
after the last epoch, a softmax of dG / dO^2) moved 0.26 under a
control and is not compared; test_class_blending_matches_jax holds the
update itself. Planted faults read, in train loss: steps that apply a
zero gradient 1.2e-2, 1.4e-2, 1.7e-2; steps at half the rate 4.4e-2,
3.3e-2, 6.8e-2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_full_cohort
from mmnn_sts_tpu import pipeline as jpipe
from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.ops import blending as jblending
from mmnn_sts_tpu.ops import losses as jlosses
from mmnn_sts_tpu.ops import metrics as jmetrics
from mmnn_sts_tpu.train import checkpoint as jckpt
from mmnn_sts_tpu.train.evaluate import (
    classification_eval_split as jax_eval_split)
from mmnn_sts_tpu.train.loop import LoopConfig as JaxLoopConfig
from mmnn_sts_tpu.train.loop import train_classification as jax_train
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_tpu.train.steps import classification_eval_step as jax_eval_step
from mmnn_sts_tpu.train.steps import classification_train_step as jax_step
from mmnn_sts_torch import pipeline as tpipe
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
from mmnn_sts_torch.models.densenet import DenseNet, tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops import blending, losses, metrics
from mmnn_sts_torch.train import checkpoint as tckpt
from mmnn_sts_torch.train.evaluate import classification_eval_split
from mmnn_sts_torch.train.loop import LoopConfig, train_classification
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    classification_eval_step, classification_train_step)
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

B, SIDE, P, C = 4, 16, 11, 2
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)
LOSS_RTOL = 1e-6
STEP_RTOL = 1e-5
STEP_LR, STEP_SPE, STEP_EPOCHS = 2.5, 2, 3  # step-0 learning rate 0.1
N_COHORT, LR, EPOCHS = 36, 2e-4, 3
CONTROLS = (1.0 + 2.0 ** -22, 1.0 - 2.0 ** -22)  # input scales
CONTROL_FACTOR, CONTROL_FLOOR = 3.0, 1e-4
UPDATE_CAP = 0.25  # a step at half the rate reads 0.5, no step 1.0
REPRODUCIBLE = 1e-3  # loop values compared where the controls stay below


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _logits(seed=0, shape=(3, 5, C)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    y = (rng.random(shape[-2:]) < 0.4).astype(np.float32)
    return x, y


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bce_with_logits_matches_jax(reduction, weighted, masked):
    x, y = _logits(1, (6, C))
    pw = np.array([0.5, 3.0], np.float32) if weighted else None
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32) if masked else None
    want = np.asarray(jlosses.bce_with_logits(
        jnp.asarray(x), jnp.asarray(y), pw, reduction,
        None if mask is None else jnp.asarray(mask)))
    got = losses.bce_with_logits(_t(x), _t(y), pw, reduction,
                                 None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=1e-7)


def test_probability_losses_and_pos_weight_match_jax():
    x, y = _logits(2, (8, C))
    probs = 1.0 / (1.0 + np.exp(-x))
    freqs = np.array([0.25, 0.6])
    np.testing.assert_allclose(
        losses.pos_weight_from_frequencies(freqs).numpy(),
        np.asarray(jlosses.pos_weight_from_frequencies(freqs)),
        rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        losses.focal_binary_cross_entropy(_t(probs), _t(y)).numpy(),
        np.asarray(jlosses.focal_binary_cross_entropy(jnp.asarray(probs),
                                                      jnp.asarray(y))),
        rtol=LOSS_RTOL)
    for reduction in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            losses.multilabel_bce(_t(probs), _t(y), reduction).numpy(),
            np.asarray(jlosses.multilabel_bce(jnp.asarray(probs),
                                              jnp.asarray(y), reduction)),
            rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="reduction"):
        losses.bce_with_logits(_t(x), _t(y), reduction="max")


@pytest.mark.parametrize("tp,fp,fn", [([3, 0], [1, 0], [2, 0]),
                                      ([0, 4], [2, 1], [0, 0]),
                                      ([5, 1], [0, 0], [0, 3])])
def test_f1_scores_match_jax(tp, fp, fn):
    got, want = metrics.f1_scores(tp, fp, fn), jmetrics.f1_scores(tp, fp, fn)
    np.testing.assert_array_equal(got, want)  # NaN where a class is empty
    assert np.isnan(got).any() == (0 in (np.add(np.add(tp, fp), fn)))


def test_confusion_counts_match_jax():
    rng = np.random.default_rng(3)
    pred = (rng.random((20, C)) < 0.5).astype(np.float32)
    true = (rng.random((20, C)) < 0.5).astype(np.float32)
    for g, w in zip(metrics.confusion_counts(_t(pred), _t(true)),
                    jmetrics.confusion_counts(jnp.asarray(pred),
                                              jnp.asarray(true))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_class_blending_matches_jax():
    x, y = _logits(4)
    pw = np.array([2.0, 0.7], np.float32)
    mask = np.array([1, 1, 1, 0, 1], np.float32)
    weights = np.array([0.5, 0.3, 0.2], np.float32)
    jstate = jblending.blend_init(3).replace(weights=jnp.asarray(weights))
    state = blending.blend_init(3)
    state.weights = _t(weights)
    np.testing.assert_allclose(
        blending.class_head_losses(_t(x), _t(y), _t(pw), _t(mask)).numpy(),
        np.asarray(jblending.class_head_losses(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(pw),
            jnp.asarray(mask))), rtol=LOSS_RTOL)
    for g, w in zip(blending.blended_class_loss(state, _t(x), _t(y), _t(pw)),
                    jblending.blended_class_loss(jstate, jnp.asarray(x),
                                                 jnp.asarray(y),
                                                 jnp.asarray(pw))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        blending.class_elementwise_losses(_t(x), _t(y), _t(pw)).numpy(),
        np.asarray(jblending.class_elementwise_losses(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(pw))),
        rtol=LOSS_RTOL)
    # two updates with the classification sign convention
    tr = [np.array([3.0, 2.5, 4.0], np.float32),
          np.array([2.0, 2.4, 3.1], np.float32)]
    va = [np.array([3.5, 2.9, 4.2], np.float32),
          np.array([3.3, 2.6, 4.1], np.float32)]
    for t, v in zip(tr, va):
        state = blending.blend_update(state, _t(t), _t(v), survival=False)
        jstate = jblending.blend_update(jstate, jnp.asarray(t),
                                        jnp.asarray(v), False)
    np.testing.assert_allclose(state.weights.numpy(),
                               np.asarray(jstate.weights), rtol=1e-6)


# -- one train step ---------------------------------------------------------

def _batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    inputs = {"image": (rng.normal(size=(B,) + (SIDE,) * 3 + (2,)) ** 2
                        * 500 * scale).astype(np.float32),
              "clinical": (rng.normal(size=(B, P)) * scale).astype(np.float32)}
    labels = np.array([[1, 0], [0, 1], [1, 1], [0, 0]], np.float32)
    return inputs, labels


def _jax_step_state():
    image = jax_tiny_densenet(**TINY, out_channels=C, dropout_prob=0.0,
                              use_pallas=True, pallas_interpret=True)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=P,
                          num_classes=C, num_features=4, blend=True,
                          clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((B,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((B, P))}
    state = jax_create_state(
        model, jax_make_optimizer(STEP_LR, STEP_SPE, STEP_EPOCHS), sample,
        seed=0)
    flat = randomise(jax_flat({"params": state.params,
                               "batch_stats": state.batch_stats}), seed=3)
    variables = jax_variables(flat)
    return state.replace(params=variables["params"],
                         batch_stats=variables["batch_stats"]), flat


def _port_step_state(flat):
    model = MultiModalModel(
        tiny_densenet(**TINY, out_channels=None, dropout_prob=0.0), P,
        num_classes=C, num_features=4, blend=True, clinical_dropout_prob=0.0)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), STEP_LR, STEP_SPE,
                                STEP_EPOCHS)
    return create_train_state(model, opt, sched, seed=0)


MASK = np.array([1, 1, 1, 0], np.float32)
POS_WEIGHT = np.array([1.5, 0.8], np.float32)


def _run_jax_step(scale=1.0):
    state, before = _jax_step_state()
    inputs, labels = _batch(1, scale)
    new, aux = jax_step(state, {k: jnp.asarray(v) for k, v in inputs.items()},
                        jnp.asarray(labels), jnp.asarray(POS_WEIGHT),
                        jax.random.key(0), blend=True, augment=False,
                        mask=jnp.asarray(MASK))
    return before, dict(loss=float(aux["loss"]), preds=np.asarray(aux["preds"]),
                        after=jax_flat({"params": new.params,
                                        "batch_stats": new.batch_stats}),
                        state=new)


@pytest.fixture(scope="module")
def step():
    before, want = _run_jax_step()
    _, control = _run_jax_step(CONTROLS[0])
    state = _port_step_state(before)
    inputs, labels = _batch(1)
    aux = classification_train_step(
        state, {k: _t(v) for k, v in inputs.items()}, _t(labels),
        _t(POS_WEIGHT), blend=True, augment=False, mask=_t(MASK))
    got = dict(loss=aux["loss"].item(), preds=aux["preds"].numpy(),
               after=to_jax_flat(state.model.state_dict(), layout="fused"),
               state=state)
    return before, want, got, control


def test_train_step_loss_and_logits_match_jax(step):
    _, want, got, _ = step
    assert got["state"].step == 1
    assert got["preds"].shape == want["preds"].shape == (3, B, C)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_RTOL)
    np.testing.assert_allclose(got["preds"], want["preds"], rtol=STEP_RTOL,
                               atol=STEP_RTOL)


def _update_err(before, a, b):
    """Relative L2 of update a against update b, over all parameters."""
    da, db = [], []
    for key, old in before.items():
        if key.startswith("params/"):
            da.append((np.asarray(a[key]) - old).ravel())
            db.append((np.asarray(b[key]) - old).ravel())
    da, db = np.concatenate(da), np.concatenate(db)
    return np.linalg.norm(da - db) / np.linalg.norm(db)


def test_train_step_update_matches_jax(step):
    """Every BatchNorm statistic elementwise; the parameters' update in
    relative L2 over all parameters, within CONTROL_FACTOR x the JAX
    control's distance (or CONTROL_FLOOR), and below UPDATE_CAP."""
    before, want, got, control = step
    assert sorted(got["after"]) == sorted(want["after"]) == sorted(before)
    for key in before:
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got["after"][key],
                                       np.asarray(want["after"][key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    port = _update_err(before, got["after"], want["after"])
    ctrl = _update_err(before, control["after"], want["after"])
    assert port <= max(CONTROL_FACTOR * ctrl, CONTROL_FLOOR), (port, ctrl)
    assert port < UPDATE_CAP, (port, ctrl)


def test_eval_split_matches_jax(step):
    """``classification_eval_split`` in chunks of 3 on the weights the JAX
    step left, against the JAX function on them."""
    _, want, _, _ = step
    state = _port_step_state(want["after"])
    rng = np.random.default_rng(6)
    n = 7
    image = (rng.normal(size=(n,) + (SIDE,) * 3 + (2,)) ** 2 * 500
             ).astype(np.float32)
    clinical = rng.normal(size=(n, P)).astype(np.float32)
    labels = (rng.random((n, C)) < 0.5).astype(np.float32)
    from mmnn_sts_torch.data.loader import build_device_dataset
    from mmnn_sts_tpu.data.loader import build_device_dataset as jax_dataset

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jds = jax_dataset(np.arange(n), mesh, image_volumes=image,
                      clinical=clinical, labels=labels)
    ds = build_device_dataset(np.arange(n), "cpu", image_volumes=image,
                              clinical=clinical, labels=labels)
    w = jax_eval_split(want["state"], jds, jnp.asarray(POS_WEIGHT),
                       blend=True, chunk=3)
    g = classification_eval_split(state, ds, _t(POS_WEIGHT), blend=True,
                                  chunk=3)
    for key in ("preds", "elementwise", "loss"):
        np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert g["preds"].shape == (3, n, C) and g["elementwise"].shape == (n, C)


# -- the loop twin ----------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("class_loop")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfgs = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        cfg.data.data_loc = paths["clinical"]
        cfg.data.image_loc = paths["root"]
        cfg.data.key_loc = paths["key"]
        cfg.image_model.spatial_size = [SIDE] * 3
        cfgs.append(cfg)
    flags = dict(images=True, preop=True, classification=True, blend=True,
                 split=True)
    cwd = os.getcwd()
    os.chdir(root)  # --split writes its uid files to the working directory
    try:
        tb = tpipe.load_cohort(cfgs[0], tpipe.TaskFlags(**flags))
        train, val, _ = tpipe.resolve_splits(cfgs[0], tpipe.TaskFlags(**flags),
                                             tb, 42)
        jb = jpipe.load_cohort(cfgs[1], jpipe.TaskFlags(**flags))
    finally:
        os.chdir(cwd)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return dict(train=train, val=val, mesh=mesh, cfgs=cfgs, tbundle=tb,
                jbundle=jb, flags=flags)


def _spe(c):
    return -(-len(c["train"]) // B)


def _jax_loop_state(c):
    model = JaxMultiModal(
        image_model=JaxDenseNet(**NARROW, out_channels=C, dropout_prob=0.0),
        num_clinical_inputs=P, num_classes=C, num_features=4, blend=True,
        clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((1,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((1, P))}
    return jax_create_state(model, jax_make_optimizer(LR, _spe(c), EPOCHS),
                            sample, seed=0)


def _port_loop_state(c, flat):
    model = MultiModalModel(
        DenseNet(**NARROW, out_channels=None, dropout_prob=0.0), P,
        num_classes=C, num_features=4, blend=True, clinical_dropout_prob=0.0)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), LR, _spe(c), EPOCHS)
    return create_train_state(model, opt, sched, seed=0)


def _loop_kw(out):
    return dict(epochs=EPOCHS, batch_size=B, blend=True,
                blend_update_interval=1, seed=42, output_dir=str(out),
                augment=False, save_params_name="model.npz")


def _run_jax_loop(c, out, scale=1.0):
    state = _jax_loop_state(c)
    init = jax_flat({"params": state.params, "batch_stats": state.batch_stats})
    jflags = jpipe.TaskFlags(**c["flags"])
    train_ds, val_ds = (jpipe.make_split_dataset(
        c["cfgs"][1], jflags, c["jbundle"], u, c["mesh"])
        for u in (c["train"], c["val"]))
    if scale != 1.0:
        for ds in (train_ds, val_ds):
            for name in ("image", "clinical"):
                ds.inputs[name] = ds.inputs[name] * jnp.float32(scale)
    return init, jax_train(state, train_ds, val_ds,
                           JaxLoopConfig(**_loop_kw(out)))


def _port_datasets(c):
    tflags = tpipe.TaskFlags(**c["flags"])
    return [tpipe.make_split_dataset(c["cfgs"][0], tflags, c["tbundle"], u,
                                     "cpu") for u in (c["train"], c["val"])]


@pytest.fixture(scope="module")
def twin(cohort, tmp_path_factory):
    outs = {k: tmp_path_factory.mktemp(k)
            for k in ("jax", "ctrl0", "ctrl1", "port")}
    init, want = _run_jax_loop(cohort, outs["jax"])
    controls = [_run_jax_loop(cohort, outs[f"ctrl{i}"], s)[1]
                for i, s in enumerate(CONTROLS)]
    got = train_classification(_port_loop_state(cohort, init),
                               *_port_datasets(cohort),
                               LoopConfig(**_loop_kw(outs["port"])))
    return dict(want=want, controls=controls, got=got, init=init,
                out=outs)


def _blend(out):
    return np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")


def _held(g, w, cs, what, reproducible=REPRODUCIBLE):
    """Per entry, the port's relative distance from JAX within
    CONTROL_FACTOR x the controls' larger one (or CONTROL_FLOOR), where
    both controls stay below ``reproducible``; returns the compared
    mask."""
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    scale = np.maximum(np.abs(w), 1e-12)
    port = np.abs(g - w) / scale
    control = np.max([np.abs(np.asarray(c, np.float64) - w) / scale
                      for c in cs], axis=0)
    compared = control <= reproducible
    limit = np.maximum(CONTROL_FACTOR * control, CONTROL_FLOOR)
    assert np.all(port[compared] <= limit[compared]), (what, port, control)
    return compared


def test_loop_twin_matches_jax(twin, cohort):
    want, ctrls, got = twin["want"], twin["controls"], twin["got"]
    assert len(cohort["train"]) % B != 0  # a ragged tail every epoch
    assert got.state.step == int(want.state.step) == EPOCHS * _spe(cohort)
    assert got.state.epoch == int(want.state.epoch) == EPOCHS

    for key in ("train_loss", "val_loss"):
        compared = _held(got.history[key], want.history[key],
                         [c.history[key] for c in ctrls], key)
        assert compared[0], key  # the first epoch is always held
    out = twin["out"]
    blends = [_blend(out[k]) for k in ("port", "jax", "ctrl0", "ctrl1")]
    assert blends[0].shape == (EPOCHS + 1, 3)
    np.testing.assert_allclose(blends[0].sum(1), 1.0, rtol=1e-6)
    _held(blends[0], blends[1], blends[2:], "blend weights")
    for key in ("train_f1", "val_f1"):
        g, w = (np.asarray(r.history[key]) for r in (got, want))
        kept = np.all([(np.asarray(c.history[key]) == w)
                       | (np.isnan(c.history[key]) & np.isnan(w))
                       for c in ctrls], axis=0)
        np.testing.assert_array_equal(g[kept], w[kept], err_msg=key)
    if all(c.best_epoch == want.best_epoch for c in ctrls):
        assert got.best_epoch == want.best_epoch


def test_metrics_rows_match_jax(twin):
    def rows(out):
        with open(out / "metrics.jsonl") as f:
            return [json.loads(x) for x in f]

    got, want = rows(twin["out"]["port"]), rows(twin["out"]["jax"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["kind"] == w["kind"] == \
            "classification_epoch"
    names = {"model.npz", "final_model.npz", "metrics.jsonl",
             "gblend_weights_history.csv"}
    assert names <= set(os.listdir(twin["out"]["port"]))
    assert names <= set(os.listdir(twin["out"]["jax"]))


def test_model_npz_loads_into_jax(twin, cohort):
    """The port's best ``model.npz`` in the JAX model gives the port's eval
    outputs on the validation split."""
    path = twin["out"]["port"] / "model.npz"
    jstate = _jax_loop_state(cohort)
    params, stats = jckpt.load_params_npz(str(path), jstate.params,
                                          jstate.batch_stats)
    jstate = jstate.replace(params=params, batch_stats=stats)
    jflags = jpipe.TaskFlags(**cohort["flags"])
    jval = jpipe.make_split_dataset(cohort["cfgs"][1], jflags,
                                    cohort["jbundle"], cohort["val"],
                                    cohort["mesh"])
    pw = np.ones(C, np.float32)
    want = jax_eval_step(jstate, jval.model_inputs(), jval.labels,
                         jnp.asarray(pw), blend=True)
    state = _port_loop_state(cohort, twin["init"])
    tckpt.load_params_npz(str(path), state.model)
    _, tval = _port_datasets(cohort)
    got = classification_eval_step(state, tval.model_inputs(), tval.labels,
                                   _t(pw), blend=True)
    for key in ("loss", "preds", "elementwise"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)

