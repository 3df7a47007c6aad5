"""The port's survival training loop (``train/loop.train_survival``) and
checkpoints (``train/checkpoint.py``) held against the JAX package's.

**Loop twin.** ``train_survival`` in both packages on the same cohort
(36 patients of ``tests/fixtures.make_full_cohort`` at 16^3, the split of
``--split`` seed 42: 23 train, 6 validation), from the same weights (the
JAX init carried over by ``convert.py``), with a narrow two-block DenseNet
blend model (growth 8; the JAX side's unfused bottleneck, the JAX CLI's
default), dropout 0, ``augment=False``, batch 4 in super-batches of 8 (3
supersteps an epoch, the last ragged: 7 valid samples of 8), blending
with an update every epoch, OneCycle peak 2e-3, 3 epochs.

Compared per epoch: train and validation loss, train and validation
C-indices, the blend weights and the best epoch. The loop is sensitive to
roundoff (the superstep's update moves by ~2e-2 for a one-ulp change of
its input, ROADMAP.md Queue 3), so the tolerances come from a JAX-vs-JAX
control, the JAX loop with its input images scaled by 1 + 2^-22. Over the
3 epochs the control moved the train loss by up to 1.3e-2 (relative), the
validation loss by 4.7e-3, the blend weights by 4.2e-3 and a C-index by
0.11 (one pair of the 6-patient split); the port lay within 1.3e-3,
1.3e-4, 1.8e-4 and 0 of the JAX run (CPU). Held: losses within 5e-2
relative (2e-3 in epoch 1, before the updates have compounded), blend
weights within 5e-2, C-indices within 0.2, the same best epoch. (At a
peak rate of 5e-2 the blend weights saturate at 0 and 1 and the control
itself moves them by up to 1.)

**Checkpoint.** The port's ``best_surv_model.npz`` loads into the JAX model
through the JAX package's ``load_params_npz`` and gives the port's eval
outputs (rtol/atol 1e-4). Two epochs straight against one epoch, then a
resume for one (augmentation and dropout on, so the generator's state
matters) give the same weights, momentum, blend state and step, bit for
bit. ``AsyncNpzSaver`` writes the newest snapshot. ``import_bhb10k_backbone``
on a synthetic MONAI-layout state dict gives the weights of the JAX import
carried over by ``convert.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_full_cohort
from mmnn_sts_torch import pipeline as tpipe
from mmnn_sts_torch.config import Config
from mmnn_sts_torch.convert import from_jax_flat, load_jax_npz, to_jax_flat
from mmnn_sts_torch.models.densenet import DenseNet, tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.train import checkpoint as tckpt
from mmnn_sts_torch.train.loop import LoopConfig, train_survival
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import survival_eval_step
from mmnn_sts_tpu import pipeline as jpipe
from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_tpu.models.densenet import DenseNet as JaxDenseNet
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.train import checkpoint as jckpt
from mmnn_sts_tpu.train.loop import LoopConfig as JaxLoopConfig
from mmnn_sts_tpu.train.loop import train_survival as jax_train_survival
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_tpu.train.steps import survival_eval_step as jax_eval_step
from test_torch_convert import jax_flat

torch.set_num_threads(1)

N_COHORT, SIDE, P = 36, 16, 11
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)
LR, EPOCHS, BATCH, SUPER = 2e-3, 3, 4, 8
LOSS_RTOL, FIRST_EPOCH_RTOL, BLEND_TOL, C_TOL = 5e-2, 2e-3, 5e-2, 0.2


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfgs = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        cfg.data.data_loc = paths["clinical"]
        cfg.data.image_loc = paths["root"]
        cfg.data.key_loc = paths["key"]
        cfg.image_model.spatial_size = [SIDE] * 3
        cfgs.append(cfg)
    flags = dict(images=True, preop=True, survival=True, blend=True,
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
    return dict(root=root, train=train, val=val, mesh=mesh, cfgs=cfgs,
                tbundle=tb, jbundle=jb, flags=flags)


def _jax_datasets(c, scale=1.0):
    jflags = jpipe.TaskFlags(**c["flags"])
    out = [jpipe.make_split_dataset(c["cfgs"][1], jflags, c["jbundle"], u,
                                    c["mesh"]) for u in (c["train"], c["val"])]
    if scale != 1.0:
        for ds in out:
            ds.inputs["image"] = ds.inputs["image"] * jnp.float32(scale)
    return out


def _port_datasets(c):
    tflags = tpipe.TaskFlags(**c["flags"])
    return [tpipe.make_split_dataset(c["cfgs"][0], tflags, c["tbundle"], u,
                                     "cpu") for u in (c["train"], c["val"])]


def _spe(c):
    return -(-len(c["train"]) // SUPER)


def _jax_state(c, dropout=0.0):
    image = JaxDenseNet(**NARROW, out_channels=2, dropout_prob=dropout)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=P,
                          num_classes=2, num_features=4, blend=True,
                          clinical_dropout_prob=dropout)
    sample = {"image": jnp.zeros((1,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((1, P))}
    return jax_create_state(model, jax_make_optimizer(LR, _spe(c), EPOCHS),
                            sample, seed=0)


def _port_state(c, flat, dropout=0.0, epochs=EPOCHS):
    encoder = DenseNet(**NARROW, out_channels=None, dropout_prob=dropout)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=dropout)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), LR, _spe(c), epochs)
    return create_train_state(model, opt, sched, seed=0)


def _loop_kw(out, epochs=EPOCHS):
    return dict(epochs=epochs, batch_size=BATCH, super_batch=SUPER,
                blend=True, blend_update_interval=1, seed=42,
                output_dir=str(out), augment=False,
                save_params_name="best_surv_model.npz")


def run_jax(c, out, scale=1.0):
    state = _jax_state(c)
    init = jax_flat({"params": state.params, "batch_stats": state.batch_stats})
    train_ds, val_ds = _jax_datasets(c, scale)
    res = jax_train_survival(state, train_ds, val_ds,
                             JaxLoopConfig(**_loop_kw(out)))
    return init, res


@pytest.fixture(scope="module")
def twin(cohort, tmp_path_factory):
    jout = tmp_path_factory.mktemp("jax_run")
    pout = tmp_path_factory.mktemp("port_run")
    init, want = run_jax(cohort, jout)
    state = _port_state(cohort, init)
    train_ds, val_ds = _port_datasets(cohort)
    got = train_survival(state, train_ds, val_ds, LoopConfig(**_loop_kw(pout)))
    return dict(want=want, got=got, jout=jout, pout=pout, init=init)


def test_loop_twin_matches_jax(twin, cohort):
    want, got = twin["want"], twin["got"]
    assert len(cohort["train"]) % SUPER != 0  # a ragged tail every epoch
    assert got.state.step == int(want.state.step) == EPOCHS * _spe(cohort)
    assert got.state.epoch == int(want.state.epoch) == EPOCHS
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(got.history[key][0], want.history[key][0],
                                   rtol=FIRST_EPOCH_RTOL, err_msg=key)
    np.testing.assert_allclose(got.history["val_c"], want.history["val_c"],
                               rtol=0, atol=C_TOL)
    np.testing.assert_allclose(got.history["train_c"],
                               want.history["train_c"], rtol=0, atol=C_TOL)
    # the same best epoch, unless JAX's own selection losses of the two
    # epochs lie within the tolerance of each other
    if got.best_epoch != want.best_epoch:
        sel = [r["selection_loss"] for r in _rows(twin["jout"])]
        a, b = sel[got.best_epoch - 1], sel[want.best_epoch - 1]
        assert abs(a - b) <= LOSS_RTOL * abs(b), (got.best_epoch,
                                                   want.best_epoch, sel)
    np.testing.assert_allclose(got.best_metric, want.best_metric,
                               rtol=LOSS_RTOL)
    hist_got = np.loadtxt(twin["pout"] / "gblend_weights_history.csv",
                          delimiter=",")
    hist_want = np.loadtxt(twin["jout"] / "gblend_weights_history.csv",
                           delimiter=",")
    assert hist_got.shape == hist_want.shape == (EPOCHS + 1, 3)
    np.testing.assert_allclose(hist_got, hist_want, rtol=0, atol=BLEND_TOL)
    assert not np.allclose(hist_got[-1], hist_got[0])  # the weights moved


def _rows(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(x) for x in f]


def test_metrics_rows_match_jax(twin):
    got, want = _rows(twin["pout"]), _rows(twin["jout"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["kind"] == w["kind"]
        for key in ("train_loss", "val_loss", "selection_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL)


def test_best_npz_loads_into_jax_and_gives_the_same_eval(twin, cohort):
    path = twin["pout"] / "best_surv_model.npz"
    jstate = _jax_state(cohort)
    params, stats = jckpt.load_params_npz(str(path), jstate.params,
                                          jstate.batch_stats)
    jstate = jstate.replace(params=params, batch_stats=stats)
    _, jval = _jax_datasets(cohort)
    want = jax_eval_step(jstate, jval.model_inputs(), jval.events,
                         jval.durations, blend=True)
    state = _port_state(cohort, twin["init"])
    tckpt.load_params_npz(str(path), state.model)
    _, tval = _port_datasets(cohort)
    got = survival_eval_step(state, tval.model_inputs(), tval.events,
                             tval.durations, blend=True)
    for key in ("loss", "selection_loss", "preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_resume_is_exact(cohort, twin, tmp_path):
    """Augmentation and dropout on: 2 epochs straight, against 1 epoch of a
    2-epoch run checkpointed and then resumed into a fresh state."""
    def run(out, epochs, ckpt_dir, state):
        train_ds, val_ds = _port_datasets(cohort)
        kw = {**_loop_kw(out, epochs), "augment": True,
              "checkpoint_dir": str(ckpt_dir)}
        return train_survival(state, train_ds, val_ds, LoopConfig(**kw))

    straight_run = run(tmp_path / "a", 2, tmp_path / "ck_a",
                       _port_state(cohort, twin["init"], 0.2, epochs=2))
    straight = straight_run.state
    first = run(tmp_path / "b", 1, tmp_path / "ck_b",
                _port_state(cohort, twin["init"], 0.2, epochs=2)).state
    assert first.epoch == 1
    fresh = _port_state(cohort, twin["init"], 0.2, epochs=2)
    tckpt.CheckpointManager(str(tmp_path / "ck_b")).restore(fresh)
    assert fresh.step == first.step and fresh.epoch == 1
    resumed_run = run(tmp_path / "b", 2, tmp_path / "ck_b", fresh)
    resumed = resumed_run.state
    # the curves and the blend history carry over the interruption
    assert resumed_run.history == straight_run.history
    name = "gblend_weights_history.csv"
    assert (tmp_path / "a" / name).read_bytes() == (
        tmp_path / "b" / name).read_bytes()
    assert resumed.step == straight.step and resumed.epoch == 2
    for name, want in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], want), name
    for p, q in zip(straight.optimizer.param_groups[0]["params"],
                    resumed.optimizer.param_groups[0]["params"]):
        assert torch.equal(straight.optimizer.state[p]["momentum_buffer"],
                           resumed.optimizer.state[q]["momentum_buffer"])
    assert torch.equal(straight.blend.weights, resumed.blend.weights)
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())
    manager = tckpt.CheckpointManager(str(tmp_path / "ck_a"))
    assert manager.latest_step() == 2
    assert manager.metrics(2)["best_epoch"] in (1, 2)


def test_checkpoint_manager_keeps_newest_and_best(tmp_path, cohort, twin):
    state = _port_state(cohort, twin["init"])
    manager = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step, metric in [(1, -1.0), (2, -5.0), (3, -3.0), (4, -4.0)]:
        manager.save(step, state, {"selection_metric": metric})
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt"))
    assert files == ["ckpt_00000001.pt", "ckpt_00000003.pt",
                     "ckpt_00000004.pt"]
    assert manager.best_step() == 1 and manager.latest_step() == 4


def test_async_npz_saver_writes_the_newest_snapshot(tmp_path, cohort, twin):
    state = _port_state(cohort, twin["init"])
    path = tmp_path / "best.npz"
    saver = tckpt.AsyncNpzSaver()
    for i in range(4):
        with torch.no_grad():
            state.model.output_head.bias.fill_(float(i))
        saver.submit(str(path), state.model)
    saver.close()
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    assert np.all(flat["params/output_head/bias"] == 3.0)
    assert sorted(flat) == sorted(to_jax_flat(state.model.state_dict()))


def test_bhb10k_import_matches_jax(tmp_path):
    """A MONAI-layout DenseNet state dict (``module.`` prefixed, with a
    classifier head and one wrongly shaped tensor that both imports skip)
    onto a TinyDenseNet encoder in both packages."""
    port = tiny_densenet(**TINY, out_channels=None)
    rng = np.random.default_rng(0)
    sd = {}
    for name, t in port.state_dict().items():
        parts = name.split(".")
        scope, leaf = parts[:-1], parts[-1]
        if scope[0].startswith("block"):
            b, l = scope[0][5:].split("_layer")
            base = f"features.denseblock{b}.denselayer{l}."
            if scope[1] == "fused1":
                leaf_map = {"scale": ("norm1", "weight"),
                            "bias": ("norm1", "bias"),
                            "mean": ("norm1", "running_mean"),
                            "var": ("norm1", "running_var"),
                            "kernel": ("conv1", "weight")}
                mod, leaf = leaf_map[leaf]
                key = base + f"{mod}.{leaf}"
                shape = (t.shape[1], t.shape[0], 1, 1, 1) if mod == "conv1" \
                    else tuple(t.shape)
            else:
                key, shape = base + f"{scope[1]}.{leaf}", tuple(t.shape)
        elif scope[0] in ("conv0", "norm0", "norm5") or \
                scope[0].startswith("transition"):
            key, shape = "features." + name, tuple(t.shape)
        else:
            continue  # the feature layer: not in the backbone checkpoint
        sd["module." + key] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))
    sd["module.class_layers.out.weight"] = torch.zeros(2, 1024)
    sd["module.features.transition1.conv.weight"] = torch.zeros(3, 3, 1, 1, 1)
    pth = tmp_path / "bhb.pth"
    torch.save({"model": sd}, pth)

    jmodel = jax_tiny_densenet(**TINY, out_channels=2)
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((1,) + (SIDE,) * 3 + (2,)))

    def port_flat(params, stats):  # the encoder's keys, without the head
        return {k: v for k, v in jax_flat(
            {"params": params, "batch_stats": stats}).items()
            if not k.startswith("params/out/")}

    # both start from the JAX init, so the skipped tensors agree too
    load_jax_npz(port, port_flat(variables["params"],
                                 variables["batch_stats"]))
    got_n = tckpt.import_bhb10k_backbone(str(pth), port)
    params, stats, want_n = jckpt.import_bhb10k_backbone(
        str(pth), variables["params"], variables["batch_stats"])
    want = from_jax_flat(port_flat(params, stats))
    assert got_n == want_n > 0
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    # the skipped tensor kept its init, the loaded ones the checkpoint's
    assert got["transition1.conv.weight"].abs().sum() > 0
    assert torch.equal(got["conv0.weight"], sd["module.features.conv0.weight"])
