"""``TPU.fused_epoch`` in the port: ``train/steps.survival_train_epoch`` and
``classification_train_epoch`` (each step a CUDA graph replay on the card,
``train/graphs.py``; on the CPU the same bodies eagerly over the same
buffers), the foreach SGD at a device learning rate (``train/state.py``),
and the loop's choice of path (``train/loop.py``).

* **Against JAX.** The port's epoch functions and the JAX package's
  ``survival_train_epoch`` and ``classification_train_epoch`` (jitted) from
  the same weights on the same split, with a ragged tail and ``with_val``,
  ``augment=False`` and dropout 0 (random bits cannot match): a narrow
  two-block DenseNet blend model (growth 8) at 16^3, the JAX side's
  unfused bottleneck, OneCycle peak 2e-3. Losses, predictions and the
  validation outputs within rtol/atol 1e-4, as
  tests/test_torch_train_steps.py holds one superstep.
* **Against the port's own steps.** The epoch functions against a loop of
  ``survival_train_superstep`` / ``classification_train_step`` (and the
  eval step) from the same state, with the augmentation and dropout 0.2
  on, with and without ``TPU.remat``: every output, parameter, running
  statistic, momentum buffer, the step and the generator's end state bit
  for bit.
* **The loop.** ``train_survival`` and ``train_classification`` with
  ``fused_epoch`` on against off (the same histories and weights bit for
  bit), the fused run resumed from a checkpoint against the straight one;
  every body bound once in a run with a blend update every epoch, the
  blend weights updated in place. Planted (each checked inside its test):
  a blend update that replaces the tensors binds the bodies again, and
  with the address check also off the graphs' inputs go stale and the run
  leaves the unfused one. ``val_interval`` with the stale-prediction
  recompute (tests/test_loop_stats.py:179's counterpart).
* **The update.** ``TrainState.device_update`` against ``torch.optim.SGD``
  (nesterov, weight decay) bit for bit on the CPU at the OneCycle rates,
  a run of fewer than 4 steps (the guard) and a NaN rate included.
* **The CLI** with ``"TPU": {"fused_epoch": true}`` on ``--device cpu``
  against the same run without it, survival and classification.
On the card, tests/test_torch_fused_epoch_cuda.py holds the graphs
against eager.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_torch.convert import load_jax_npz
from mmnn_sts_torch.data.loader import (
    EpochBatcher, build_device_dataset, gather_superbatch)
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops import blending
from mmnn_sts_torch.train import checkpoint as tckpt
from mmnn_sts_torch.train import graphs, loop
from mmnn_sts_torch.train.loop import (
    LoopConfig, train_classification, train_survival)
from mmnn_sts_torch.train.schedule import make_optimizer, onecycle
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    classification_eval_step, classification_train_epoch,
    classification_train_step, survival_eval_step, survival_train_epoch,
    survival_train_superstep)
from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_tpu.train.steps import \
    classification_train_epoch as jax_classification_epoch
from mmnn_sts_tpu.train.steps import survival_train_epoch as jax_survival_epoch
from test_torch_convert import jax_flat

torch.set_num_threads(1)

SIDE, P = 16, 11
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)
TOL = dict(rtol=1e-4, atol=1e-4)
LR, EPOCHS = 2e-3, 3
# survival: supersteps of A x B, 6 samples = one full superstep and a tail
# with one valid microbatch; classification: batches of 4, 7 samples = one
# full batch and a tail of 3
A, B, N_SURV = 2, 2, 6
CB, N_CLASS = 4, 7
N_VAL = 5


def _split(seed, n, survival=True):
    rng = np.random.default_rng(seed)
    arrays = {"image_volumes": (rng.normal(size=(n,) + (SIDE,) * 3 + (2,))
                                ** 2 * 500).astype(np.float32),
              "clinical": rng.normal(size=(n, P)).astype(np.float32)}
    if survival:
        arrays["events"] = (rng.random((n, 2)) < 0.7).astype(np.float32)
        arrays["durations"] = rng.integers(1, 4, (n, 2)).astype(np.float32)
    else:
        arrays["labels"] = (rng.random((n, 2)) < 0.5).astype(np.float32)
    return arrays


def _ds(arrays):
    return build_device_dataset(np.arange(len(arrays["clinical"])), "cpu",
                                **arrays)


def _jax_flat(spe):
    image = JaxDenseNet(**NARROW, out_channels=2, dropout_prob=0.0)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=P,
                          num_classes=2, num_features=4, blend=True,
                          clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((1,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((1, P))}
    state = jax_create_state(model, jax_make_optimizer(LR, spe, EPOCHS),
                             sample, seed=0)
    return state, jax_flat({"params": state.params,
                            "batch_stats": state.batch_stats})


def _port_state(flat, spe, dropout=0.0, remat=False, epochs=EPOCHS):
    encoder = DenseNet(**NARROW, out_channels=None, dropout_prob=dropout,
                       remat=remat)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=dropout)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), LR, spe, epochs)
    return create_train_state(model, opt, sched, seed=0)


@pytest.fixture(scope="module")
def flat():
    """The JAX init's weights (numpy, flat key scheme)."""
    return _jax_flat(2)[1]


def _rows(n, micro, accum, seed=0, epoch=0):
    batcher = EpochBatcher(n, micro, accum, seed=seed, two_level=accum > 1)
    order = batcher.epoch_indices(epoch)
    return order[:-1], order[-1], batcher.pad_mask()[-1]


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _inputs(arrays):
    return {"image": arrays["image_volumes"], "clinical": arrays["clinical"]}


def test_survival_epoch_matches_jax():
    train, val = _split(1, N_SURV), _split(2, N_VAL)
    idx, tail, mask = _rows(N_SURV, B, A)
    jstate, flat = _jax_flat(2)
    _, want = jax_survival_epoch(
        jstate, _jnp(_inputs(train)), jnp.asarray(train["events"]),
        jnp.asarray(train["durations"]), jnp.asarray(idx, jnp.int32),
        jax.random.key(0), val_inputs=_jnp(_inputs(val)),
        val_events=jnp.asarray(val["events"]),
        val_durations=jnp.asarray(val["durations"]), blend=True,
        augment=False, with_val=True,
        tail_idx=jnp.asarray(tail, jnp.int32), tail_mask=jnp.asarray(mask))
    state = _port_state(flat, 2)
    got = survival_train_epoch(state, _ds(train), idx, tail,
                               torch.as_tensor(mask), val_ds=_ds(val),
                               blend=True, augment=False, with_val=True)
    assert state.step == 2 and got["loss"].shape == (2,)
    for key in ("loss", "preds", "val_preds", "val_loss", "val_selection"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_classification_epoch_matches_jax():
    train, val = _split(3, N_CLASS, False), _split(4, N_VAL, False)
    idx, tail, mask = _rows(N_CLASS, CB, 1)
    jstate, flat = _jax_flat(2)
    pos_weight = np.asarray([1.5, 0.75], np.float32)
    _, want = jax_classification_epoch(
        jstate, _jnp(_inputs(train)), jnp.asarray(train["labels"]),
        jnp.asarray(pos_weight), jnp.asarray(idx, jnp.int32),
        jax.random.key(0), val_inputs=_jnp(_inputs(val)),
        val_labels=jnp.asarray(val["labels"]), blend=True, augment=False,
        with_val=True, tail_idx=jnp.asarray(tail, jnp.int32),
        tail_mask=jnp.asarray(mask))
    state = _port_state(flat, 2)
    got = classification_train_epoch(
        state, _ds(train), torch.as_tensor(pos_weight), idx, tail,
        torch.as_tensor(mask), val_ds=_ds(val), blend=True, augment=False,
        with_val=True)
    assert state.step == 2
    for key in ("loss", "preds", "val_preds", "val_elementwise", "val_loss"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def _everything(state, out: dict) -> dict:
    tensors = {f"out {k}": v for k, v in out.items()}
    tensors.update({f"param {n}": p.detach() for n, p in
                    state.model.named_parameters()})
    tensors.update({f"buffer {n}": b for n, b in
                    state.model.named_buffers()})
    tensors.update({f"momentum {i}": b for i, b in
                    enumerate(state.momentum_buffers())})
    tensors["generator"] = state.generator.get_state()
    tensors["step"] = torch.tensor(state.step)
    return tensors


def _assert_bitwise(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _survival_loop(state, ds, val_ds, idx, tail, mask):
    losses, preds = [], []
    for step_idx, m in [(i, None) for i in idx] + [(tail, mask)]:
        batch = gather_superbatch(ds, step_idx)
        aux = survival_train_superstep(
            state, batch["inputs"], batch["events"], batch["durations"],
            blend=True, augment=True, mask=m)
        losses.append(aux["loss"])
        preds.append(aux["preds"])
    ev = survival_eval_step(state, val_ds.model_inputs(), val_ds.events,
                            val_ds.durations, blend=True)
    return {"loss": torch.stack(losses), "preds": torch.stack(preds),
            "val_preds": ev["preds"], "val_loss": ev["loss"],
            "val_selection": ev["selection_loss"]}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_survival_epoch_is_the_superstep_loop(flat, remat):
    """Augmentation and dropout 0.2 on: two epochs of the epoch function
    against the same supersteps one at a time, bit for bit (the second
    epoch through bodies bound in the first)."""
    train, val = _ds(_split(5, N_SURV)), _ds(_split(6, N_VAL))
    mask = torch.as_tensor(_rows(N_SURV, B, A)[2])
    fused = _port_state(flat, 2, dropout=0.2, remat=remat)
    fused.ensure_rates(4)  # both epochs' rates: a grown table binds again
    eager = _port_state(flat, 2, dropout=0.2, remat=remat)
    for epoch in range(2):
        idx, tail, _ = _rows(N_SURV, B, A, epoch=epoch)
        got = survival_train_epoch(fused, train, idx, tail, mask,
                                   val_ds=val, blend=True, augment=True,
                                   with_val=True)
        want = _survival_loop(eager, train, val, idx, tail, mask)
        _assert_bitwise(_everything(fused, got), _everything(eager, want))
    bodies = [g for e in fused.graphs.values()
              for g in getattr(e, "graphs", {}).values()]
    assert [g.binds for g in bodies] == [1, 1]


def test_classification_epoch_is_the_step_loop(flat):
    train, val = _ds(_split(7, N_CLASS, False)), _ds(_split(8, N_VAL, False))
    idx, tail, mask = _rows(N_CLASS, CB, 1)
    mask = torch.as_tensor(mask)
    pos_weight = torch.tensor([1.5, 0.75])
    fused = _port_state(flat, 2, dropout=0.2)
    eager = _port_state(flat, 2, dropout=0.2)
    got = classification_train_epoch(fused, train, pos_weight, idx, tail,
                                      mask, val_ds=val, blend=True,
                                      augment=True, with_val=True)
    losses, preds = [], []
    for step_idx, m in [(i, None) for i in idx] + [(tail, mask)]:
        batch = gather_superbatch(train, step_idx)
        aux = classification_train_step(eager, batch["inputs"],
                                        batch["labels"], pos_weight,
                                        blend=True, augment=True, mask=m)
        losses.append(aux["loss"])
        preds.append(aux["preds"])
    ev = classification_eval_step(eager, val.model_inputs(), val.labels,
                                  pos_weight, blend=True)
    want = {"loss": torch.stack(losses), "preds": torch.stack(preds),
            "val_preds": ev["preds"], "val_elementwise": ev["elementwise"],
            "val_loss": ev["loss"]}
    _assert_bitwise(_everything(fused, got), _everything(eager, want))


# --- the loop ------------------------------------------------------------

N_LOOP, N_LOOP_VAL = 10, 5


def _loop_data(survival):
    return (_ds(_split(11, N_LOOP, survival)),
            _ds(_split(12, N_LOOP_VAL, survival)))


def _loop_cfg(tmp, fused, survival, **kw):
    return LoopConfig(**{**dict(
        epochs=EPOCHS, batch_size=2 if survival else CB, super_batch=4,
        blend=True, blend_update_interval=1, seed=42, output_dir=str(tmp),
        augment=True, fused_epoch=fused), **kw})


def _loop_state(flat, survival, epochs=EPOCHS):
    spe = -(-N_LOOP // (4 if survival else CB))
    return _port_state(flat, spe, dropout=0.2, epochs=epochs)


def _run_loop(flat, tmp, fused, survival, **kw):
    state = _loop_state(flat, survival)
    train_ds, val_ds = _loop_data(survival)
    blend = state.blend
    train = train_survival if survival else train_classification
    result = train(state, train_ds, val_ds,
                   _loop_cfg(tmp, fused, survival, **kw))
    assert result.state.blend is blend  # updated in place
    return result


def _bodies(state):
    return [g for v in state.graphs.values()
            for g in (v.graphs.values() if isinstance(v, graphs.EpochSteps)
                      else [v])]


@pytest.mark.parametrize("survival", [True, False],
                         ids=["survival", "classification"])
def test_loop_fused_matches_unfused(flat, tmp_path, survival):
    """Three epochs with a blend update each, augmentation and dropout
    on: the same history, weights and generator, bit for bit; every body
    (step, tail, validation) bound once."""
    want = _run_loop(flat, tmp_path / "a", False, survival)
    got = _run_loop(flat, tmp_path / "b", True, survival)
    assert got.history == want.history
    _assert_bitwise(_everything(got.state, {}), _everything(want.state, {}))
    assert not want.state.graphs
    assert [g.binds for g in _bodies(got.state)] == [1, 1, 1]
    assert (tmp_path / "a" / "gblend_weights_history.csv").read_bytes() == \
        (tmp_path / "b" / "gblend_weights_history.csv").read_bytes()


def test_blend_update_in_place_planted_faults(flat, tmp_path, monkeypatch):
    """The blend update copies into the bound tensors. Planted: an update
    that replaces them (the loop's ``state.blend = ...`` of before) makes
    every run bind its bodies again; with the address check off as well,
    the bodies keep the old weights and the run leaves the unfused one."""
    want = _run_loop(flat, tmp_path / "a", False, True)

    def replace(state, new):
        state.weights, state.lvn, state.ltn = new.weights, new.lvn, new.ltn
        state.has_history = new.has_history
        return state

    monkeypatch.setattr(blending, "assign_blend", replace)
    rebound = _run_loop(flat, tmp_path / "b", True, True)
    assert rebound.history == want.history
    assert max(g.binds for g in _bodies(rebound.state)) > 1

    first = graphs.BoundBody._signature
    monkeypatch.setattr(graphs.BoundBody, "_signature", lambda self: (
        self.signature if self.signature is not None else first(self)))
    stale = _run_loop(flat, tmp_path / "c", True, True)
    assert stale.history["train_loss"][1:] != want.history["train_loss"][1:]


def test_loop_fused_resume_is_exact(flat, tmp_path):
    """The fused run checkpointed after one epoch of two and resumed into
    a fresh state ends where the straight fused run ends."""
    def run(out, epochs, state):
        train_ds, val_ds = _loop_data(True)
        return train_survival(state, train_ds, val_ds, _loop_cfg(
            out, True, True, epochs=epochs, checkpoint_dir=str(out / "ck")))

    straight = run(tmp_path / "a", 2, _loop_state(flat, True, epochs=2))
    run(tmp_path / "b", 1, _loop_state(flat, True, epochs=2))
    fresh = _loop_state(flat, True, epochs=2)
    tckpt.CheckpointManager(str(tmp_path / "b" / "ck")).restore(fresh)
    resumed = run(tmp_path / "b", 2, fresh)
    assert resumed.history == straight.history
    _assert_bitwise(_everything(resumed.state, {}),
                    _everything(straight.state, {}))


@pytest.mark.parametrize("fused", [False, True], ids=["steps", "fused"])
def test_blend_update_recomputes_stale_val_preds(flat, tmp_path, monkeypatch,
                                                 fused):
    """val_interval=2, blend_update_interval=3: validation runs in epoch 2
    (fused into the epoch program on the fused path); the epoch-3 blend
    update recomputes the validation predictions with the current weights
    instead of reusing epoch 2's."""
    evals = []
    real = loop.survival_eval_split

    def spy(state, *args, **kwargs):
        evals.append(int(state.epoch))
        return real(state, *args, **kwargs)

    monkeypatch.setattr(loop, "survival_eval_split", spy)
    result = _run_loop(flat, tmp_path, fused, True, val_interval=2,
                       blend_update_interval=3)
    assert evals == ([2] if fused else [1, 2])
    assert result.state.blend.has_history
    assert len(result.history["val_loss"]) == 1
    assert len(result.history["train_loss"]) == EPOCHS


# --- the update ------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["onecycle", "under4", "nan"])
def test_device_update_is_torch_sgd(schedule):
    """``device_update`` (foreach, the rate a device tensor at the step
    counter) against ``torch.optim.SGD`` at the same rates, nesterov
    momentum 0.9 and weight decay 1e-4: the same bits on the CPU. "under4":
    one step an epoch for two epochs (OneCycle's guard stretches it to 4
    steps); "nan": a schedule whose rate is NaN from step 3."""
    rates = {"onecycle": onecycle(0.3, 3, 2), "under4": onecycle(0.3, 1, 2),
             "nan": lambda s: float("nan") if s >= 3 else 0.1 * (s + 1)}
    sched = rates[schedule]
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3, 3), (7,), (5, 11)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ref = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    mine = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = torch.optim.SGD(ref, lr=0.0, momentum=0.9, nesterov=True,
                          weight_decay=1e-4)
    state = create_train_state(torch.nn.ParameterList(mine), torch.optim.SGD(
        mine, lr=0.0, momentum=0.9, nesterov=True, weight_decay=1e-4),
        sched)
    for step in range(6):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        for p, g in zip(ref, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.param_groups[0]["lr"] = sched(step)
        opt.step()
        for p, g in zip(mine, grads):
            p.grad = torch.from_numpy(g.copy())
        state.begin_step()
        state.device_update()
        state.step += 1
        assert state.step == step + 1 and int(state.step_t) == step + 1
        for p, q in zip(ref, mine):
            torch.testing.assert_close(q.detach(), p.detach(), rtol=0,
                                       atol=0, equal_nan=True)
        for p, q in zip(ref, mine):
            torch.testing.assert_close(
                state.optimizer.state[q]["momentum_buffer"],
                opt.state[p]["momentum_buffer"], rtol=0, atol=0,
                equal_nan=True)
    assert state.rates[:6].tolist() == pytest.approx(
        [np.float32(sched(s)) for s in range(6)], nan_ok=True)


# --- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("task", ["survival", "classification"])
def test_cli_fused_epoch_on_cpu(cli_cohort, tmp_path, monkeypatch, task):
    """``python -m mmnn_sts_torch`` with ``"TPU": {"fused_epoch": true}``
    on ``--device cpu``: the metrics of the run without it."""
    from mmnn_sts_torch.cli import main

    monkeypatch.chdir(tmp_path)
    rows = {}
    for fused in (False, True):
        cfg = {**cli_cohort, "TPU": {"fused_epoch": fused}}
        path = tmp_path / f"cfg_{fused}.json"
        path.write_text(json.dumps(cfg))
        out = tmp_path / f"out_{fused}"
        assert main(["--images", "--preop", f"--{task}", "--blend",
                     "--split", "--config", str(path), "--output_path",
                     str(out), "--epochs", "2", "--blend_update_interval",
                     "1", "--device", "cpu"]) == 0
        rows[fused] = [json.loads(x) for x in
                       (out / "metrics.jsonl").read_text().splitlines()]
    drop = ("epoch_seconds", "samples_per_sec", "ts")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in rows[True]] == [{k: v for k, v in r.items()
                                      if k not in drop} for r in rows[False]]


@pytest.fixture(scope="module")
def cli_cohort(tmp_path_factory):
    from fixtures import make_full_cohort

    root = tmp_path_factory.mktemp("cohort")
    paths, _ = make_full_cohort(str(root), n=20)
    return {"Data": {"data_loc": paths["clinical"],
                     "image_loc": paths["root"], "key_loc": paths["key"]},
            "ImageModel": {"name": "tinydensenet",
                           "spatial_size": [SIDE] * 3},
            "Hyperparameters": {"train_batch_size": 4}}
