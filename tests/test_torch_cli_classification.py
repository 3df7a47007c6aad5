"""``python -m mmnn_sts_torch --classification`` held against the JAX
package's CLI, then the port's ``--inference --classification`` on the
weights it trained, and both task paths with the JAX package blocked.

A classification run, ``--images --preop --classification --blend --split
--epochs 2``, in both packages on one cohort (29 patients of
``tests/fixtures.make_full_cohort``: 19 train, so the last batch holds 3;
TinyDenseNet at 16^3 x 2ch, batch 4, rate 2e-4, one JSON config; the JAX
CLI in a one-device subprocess), from the same weights (the port registry
model's init from seed 0 in the JAX key scheme, ``--weights``). The random
augmentation and dropout draw bits that cannot match across the packages,
so both CLIs run with the augmentation off (``LoopConfig(augment=False)``)
and every dropout at 0 (``ImageModel.dropout_prob`` and the multimodal
model's ``clinical_dropout_prob``), patched in from the test. The loop
amplifies roundoff (tests/test_torch_classification.py), so the values are
held as its loop twin holds them, against two JAX runs with their inputs
scaled by 1 +- 2^-22 in the same subprocess: the metrics.jsonl losses and
the blend history by ``_held`` there, the F1s where both controls kept
them. TinyDenseNet's last block is 1^3 at 16^3, and the controls move the
first epoch's train and validation losses by 1.2e-3 and 3.8e-3 (the
second's by 5.8e-2 and 2.0e-2, not compared), so values are compared
where both controls stay below 1e-2. Measured (CPU): the port lay 1.2e-3
and 2.7e-3 from JAX in the first epoch; a step batch of
``SUPER_BATCH_SIZE`` reads 3.5e-2 in train loss, pos_weight 1 reads
2.5e-2, steps that apply a zero gradient 1.4e-2 in validation loss. The
weights' update itself moves by ~100 % in relative L2 under a control,
so the weights are not compared in value: the port's ``model.npz`` must be
its checkpoint of the epoch with the best validation F1 (the first strict
maximum) and ``final_model.npz`` that of the last. The rows' kind and
keys, the artifacts, and the npz keys, shapes and dtypes are compared
exactly.
"""

import json
import os
import subprocess
import sys
from functools import partial
from unittest import mock

import numpy as np
import pytest
import torch

from fixtures import make_full_cohort
from test_torch_classification import CONTROLS, _held
from test_torch_cli_infer import REPO, run_port_cli
from test_torch_data import run_blocked

torch.set_num_threads(1)

N_COHORT, SIDE = 29, 16
CLI_REPRODUCIBLE = 1e-2  # values compared where both controls stay below
TRAIN = ["--images", "--preop", "--classification", "--blend", "--split",
         "--epochs", "2", "--blend_update_interval", "1"]

# the JAX CLI on one CPU device with the augmentation and dropout off, once
# for each (input scale, working directory) of argv[2]
JAX_TWIN = (
    "import functools, json, os, sys\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.config.update('jax_compilation_cache_dir', sys.argv[1])\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)\n"
    "import jax.numpy as jnp\n"
    "from mmnn_sts_tpu import pipeline\n"
    "from mmnn_sts_tpu.cli import main\n"
    "from mmnn_sts_tpu.models import registry\n"
    "from mmnn_sts_tpu.train import loop\n"
    "loop.LoopConfig = functools.partial(loop.LoopConfig, augment=False)\n"
    "registry.MultiModalModel = functools.partial(\n"
    "    registry.MultiModalModel, clinical_dropout_prob=0.0)\n"
    "make = pipeline.make_split_dataset\n"
    "def scaled(scale):\n"
    "    def make_scaled(*a, **k):\n"
    "        ds = make(*a, **k)\n"
    "        for name in ('image', 'clinical'):\n"
    "            ds.inputs[name] = ds.inputs[name] * jnp.float32(scale)\n"
    "        return ds\n"
    "    return make_scaled\n"
    "for scale, workdir in json.loads(sys.argv[2]):\n"
    "    pipeline.make_split_dataset = scaled(scale)\n"
    "    os.chdir(workdir)\n"
    "    assert main(sys.argv[3:] + ['--output_path', 'out']) == 0\n"
)


def run_jax_twin(runs, args):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    res = subprocess.run(
        [sys.executable, "-c", JAX_TWIN, os.path.join(REPO, ".jax_cache"),
         json.dumps([[s, str(d)] for s, d in runs])] + args,
        env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.models import build_model, registry
    from mmnn_sts_torch.train import loop
    from mmnn_sts_torch.train.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("cli_class")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"]},
           "ImageModel": {"name": "tinydensenet", "dropout_prob": 0.0,
                          "spatial_size": [SIDE] * 3},
           "Hyperparameters": {"train_batch_size": 4, "learning_rate": 2e-4,
                               "seed": 42},
           "Preprocessing": {f"{s}_uid_location": f"{s}_uids.txt"
                             for s in ("train", "val", "test")}}
    config = root / "config.json"
    config.write_text(json.dumps(cfg))
    torch.manual_seed(0)
    init = root / "init.npz"
    save_params_npz(str(init), build_model(parse_config(str(config)), True,
                                           True, False, True))
    dirs = {name: root / name for name in ("jax", "ctrl0", "ctrl1", "port")}
    for d in dirs.values():
        d.mkdir()
    common = TRAIN + ["--config", str(config), "--weights", str(init)]
    run_jax_twin([(1.0, dirs["jax"])] + [(s, dirs[f"ctrl{i}"])
                                         for i, s in enumerate(CONTROLS)],
                 common)
    with mock.patch.object(loop, "LoopConfig",
                           partial(loop.LoopConfig, augment=False)), \
            mock.patch.object(registry, "MultiModalModel",
                              partial(registry.MultiModalModel,
                                      clinical_dropout_prob=0.0)):
        assert run_port_cli(common + ["--output_path",
                                      str(dirs["port"] / "out"),
                                      "--checkpoint_dir",
                                      str(dirs["port"] / "ck")],
                            dirs["port"]) == 0
    return dict(root=root, config=config, cfg=cfg, **dirs)


def test_split_files_match_jax(runs):
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        assert (runs["port"] / name).read_text() == \
            (runs["jax"] / name).read_text()


def _rows(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(x) for x in f]


def _column(runs, side, key):
    return np.array([r[key] for r in _rows(runs[side] / "out")], np.float64)


def test_metrics_rows_match_jax(runs):
    got, want = _rows(runs["port"] / "out"), _rows(runs["jax"] / "out")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["kind"], g["epoch"]) == (w["kind"], w["epoch"])
        assert g["kind"] == "classification_epoch"
        for key in ("train_loss", "val_loss", "epoch_seconds",
                    "samples_per_sec"):
            assert np.isfinite(g[key]), key
        for key in ("train_f1", "val_f1"):
            assert np.isnan(g[key]) or 0.0 <= g[key] <= 1.0, key
    for key in ("train_loss", "val_loss"):
        compared = _held(_column(runs, "port", key), _column(runs, "jax", key),
                         [_column(runs, c, key) for c in ("ctrl0", "ctrl1")],
                         key, CLI_REPRODUCIBLE)
        assert compared[0], key  # the first epoch is always held
    for key in ("train_f1", "val_f1"):
        g, w = _column(runs, "port", key), _column(runs, "jax", key)
        kept = np.all([(c == w) | (np.isnan(c) & np.isnan(w))
                       for c in (_column(runs, s, key)
                                 for s in ("ctrl0", "ctrl1"))], axis=0)
        np.testing.assert_array_equal(g[kept], w[kept], err_msg=key)


def _blend(runs, side):
    return np.loadtxt(runs[side] / "out" / "gblend_weights_history.csv",
                      delimiter=",")


def _best_epoch(val_f1s):
    """The epoch the loop keeps: the first strict maximum (NaN never
    wins)."""
    best, best_f1 = None, -1.0
    for epoch, f1 in enumerate(val_f1s, 1):
        if f1 > best_f1:
            best, best_f1 = epoch, f1
    return best


def test_artifacts_match_jax(runs):
    got = set(os.listdir(runs["port"] / "out"))
    want = set(os.listdir(runs["jax"] / "out"))
    # the PNGs need matplotlib; both packages draw them where it is
    assert got == want
    assert {"model.npz", "final_model.npz", "metrics.jsonl",
            "gblend_weights_history.csv", "train_val_f1.png",
            "val_loss_by_cm.png", "val_loss_by_class.png"} <= got
    from mmnn_sts_torch.convert import to_jax_flat

    epochs = {"model.npz": _best_epoch(_column(runs, "port", "val_f1")),
              "final_model.npz": 2}
    for name, epoch in epochs.items():
        with np.load(runs["port"] / "out" / name) as g, \
                np.load(runs["jax"] / "out" / name) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in g.files:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            blob = torch.load(runs["port"] / "ck" / f"ckpt_{epoch:08d}.pt",
                              map_location="cpu", weights_only=True)
            kept = to_jax_flat(blob["model"])
            assert sorted(kept) == sorted(g.files)
            for k in g.files:
                np.testing.assert_array_equal(g[k], kept[k], err_msg=k)
    hist = _blend(runs, "port")
    assert hist.shape == _blend(runs, "jax").shape == (3, 3)
    np.testing.assert_allclose(hist.sum(1), 1.0, rtol=1e-6)
    _held(hist, _blend(runs, "jax"),
          [_blend(runs, c) for c in ("ctrl0", "ctrl1")], "blend",
          CLI_REPRODUCIBLE)


def test_classification_resumes_from_its_checkpoint(runs):
    from mmnn_sts_torch.train.checkpoint import CheckpointManager

    ck = runs["port"] / "ck"
    assert CheckpointManager(str(ck)).latest_step() == 2
    rc = run_port_cli(TRAIN[:4] + [
        "--epochs", "3", "--blend_update_interval", "1", "--config",
        str(runs["config"]), "--resume", "--checkpoint_dir", str(ck),
        "--output_path", str(runs["port"] / "out")], runs["port"])
    assert rc == 0 and CheckpointManager(str(ck)).latest_step() == 3
    assert [r["epoch"] for r in _rows(runs["port"] / "out")] == [1, 2, 3]
    hist = np.loadtxt(runs["port"] / "out" / "gblend_weights_history.csv",
                      delimiter=",")
    assert hist.shape == (4, 3)


def test_inference_on_the_trained_weights(runs, tmp_path):
    cfg = dict(runs["cfg"])
    cfg["Hyperparameters"] = {**cfg["Hyperparameters"], "model_weights": str(
        runs["port"] / "out" / "model.npz")}
    config = tmp_path / "trained.json"
    config.write_text(json.dumps(cfg))
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        (tmp_path / name).write_text((runs["port"] / name).read_text())
    rc = run_port_cli(["--inference", "--images", "--preop",
                       "--classification", "--blend", "--config", str(config),
                       "--output_path", str(tmp_path / "out")], tmp_path)
    assert rc == 0
    test_uids = (tmp_path / "test_uids.txt").read_text().split()
    with open(tmp_path / "out" / "model_probabilities.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "0,1,2,3,4" and len(lines) == len(test_uids) + 1
    rows = np.array([[float(v) for v in line.split(",")]
                     for line in lines[1:]])
    assert sorted(int(u) for u in rows[:, 0]) == sorted(map(int, test_uids))
    assert ((rows[:, 1:3] >= 0) & (rows[:, 1:3] <= 1)).all()
    dirs = os.listdir(tmp_path / "out" / "attention_maps")
    for row in rows:  # the names' bits agree with the CSV
        labels = "".join(str(int(v)) for v in row[3:5])
        preds = "".join(str(int(v > 0.5)) for v in row[1:3])
        correct = "".join("1" if a == b else "0" for a, b in zip(labels, preds))
        assert f"{correct}_{labels}_{preds}__patient_{int(row[0])}" in dirs


def test_inference_and_classification_run_without_jax_pandas_or_yaml(
        runs, tmp_path):
    """The port's CLI with pandas, matplotlib, yaml, jax, flax, optax and
    the JAX package blocked: a classification epoch, then inference on its
    weights with Grad-CAM, and survival inference with the bootstrap."""
    cfg = dict(runs["cfg"])
    cfg["Hyperparameters"] = {**cfg["Hyperparameters"],
                              "model_weights": str(tmp_path / "out" /
                                                   "model.npz")}
    config = tmp_path / "config.json"
    config.write_text(json.dumps(cfg))
    args = ["--images", "--preop", "--blend", "--config", str(config),
            "--device", "cpu", "--output_path"]
    run_blocked(
        "from mmnn_sts_torch.cli import main\n"
        f"args = {args!r}\n"
        "assert main(['--classification', '--split', '--epochs', '1']\n"
        "            + args + ['out']) == 0\n"
        "assert main(['--inference', '--classification'] + args\n"
        "            + ['infer_class']) == 0\n"
        "assert main(['--inference', '--survival', '--bootstrap'] + args\n"
        "            + ['infer_surv']) == 0\n"
        "print('ok')\n",
        str(tmp_path))
    assert sorted(os.listdir(tmp_path / "out")) == [
        "final_model.npz", "gblend_weights_history.csv", "metrics.jsonl",
        "model.npz"]
    assert sorted(os.listdir(tmp_path / "infer_class")) == [
        "attention_maps", "model_probabilities.csv"]
    assert os.listdir(tmp_path / "infer_surv") == ["attention_maps"]
