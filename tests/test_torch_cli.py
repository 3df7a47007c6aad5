"""``python -m mmnn_sts_torch`` (``mmnn_sts_torch/cli.py``) held against the
JAX package's CLI.

A tiny survival run, ``--images --preop --survival --blend --split
--epochs 2``, in both packages on the same cohort (23 patients of
``tests/fixtures.make_full_cohort`` at 16^3: 16 train patients, 2
supersteps of 8 an epoch; a TinyDenseNet; one JSON config that both
packages parse; the JAX CLI on one CPU device), both starting from the
same weights (the port registry model's init from seed 0, written in the
JAX package's key scheme and passed with ``--weights``). The CLI trains with the
random augmentation and dropout on, whose bits cannot match across the
packages, so the numbers are compared in kind, not in value (the loop twin
of tests/test_torch_loop.py compares them): the same uid files, the same
metrics.jsonl rows (kinds, epochs, keys; finite losses, C-indices in
[0, 1]), a ``best_surv_model.npz`` with the JAX file's keys, shapes and
dtypes that the JAX package loads, and a blend history of the same shape.

Then ``--export_path`` with the trained weights and ``ServingModel`` on the
CPU; ``--resume`` from ``--checkpoint_dir``; the flag that is not ported
(``--segmentation``) raises ``NotImplementedError``; without CUDA and without ``--device cpu``
the CLI raises; a JSON config parses to the same ``Config`` in both
packages; and ``python -m mmnn_sts_torch`` runs in a subprocess with
pandas, matplotlib, yaml, jax, flax, optax and the JAX package blocked.
"""

import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fixtures import make_full_cohort
from mmnn_sts_torch.cli import main as port_main
from test_torch_data import BLOCK_PRELUDE, run_blocked

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COHORT, SIDE = 23, 16
RUN = ["--images", "--preop", "--survival", "--blend", "--split",
       "--epochs", "2", "--blend_update_interval", "1"]


# the JAX CLI on one CPU device (this pytest process has eight, over which
# the JAX CLI would replicate every step), with the suite's compile cache
JAX_CLI = (
    "import sys\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.config.update('jax_compilation_cache_dir', sys.argv[1])\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)\n"
    "from mmnn_sts_tpu.cli import main\n"
    "sys.exit(main(sys.argv[2:]))\n"
)


def run_jax_cli(args, workdir):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    res = subprocess.run(
        [sys.executable, "-c", JAX_CLI, os.path.join(REPO, ".jax_cache")]
        + args, cwd=workdir, env=env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]


def _in_dir(main, args, workdir):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return main(args)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("cli")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"]},
           "ImageModel": {"name": "tinydensenet",
                          "spatial_size": [SIDE] * 3},
           "Hyperparameters": {"epochs": 2, "train_batch_size": 4,
                               "learning_rate": 0.002, "seed": 42}}
    config = root / "config.json"
    config.write_text(json.dumps(cfg))

    torch.manual_seed(0)
    init = root / "init.npz"
    save_params_npz(str(init), build_model(parse_config(str(config)), True,
                                           True, False, True))

    dirs = {name: root / name for name in ("jax", "port")}
    common = RUN + ["--config", str(config), "--weights", str(init)]
    for name in dirs:
        dirs[name].mkdir()
    run_jax_cli(common + ["--output_path", str(dirs["jax"] / "out")],
                dirs["jax"])
    rc = _in_dir(port_main, common + [
        "--output_path", str(dirs["port"] / "out"), "--device", "cpu",
        "--checkpoint_dir", str(dirs["port"] / "ck")], dirs["port"])
    assert rc == 0
    return dict(root=root, config=config, init=init, paths=paths,
                common=common, **dirs)


def test_split_files_match_jax(runs):
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        assert (runs["port"] / name).read_text() == \
            (runs["jax"] / name).read_text()


def _rows(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(x) for x in f]


def test_metrics_rows_match_jax(runs):
    got, want = _rows(runs["port"] / "out"), _rows(runs["jax"] / "out")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["kind"], g["epoch"]) == (w["kind"], w["epoch"])
        for key in ("train_loss", "val_loss", "selection_loss",
                    "epoch_seconds", "samples_per_sec"):
            assert np.isfinite(g[key]), key
        for key in ("train_c", "val_c"):
            assert 0.0 <= g[key] <= 1.0, key


def test_best_npz_matches_jax(runs):
    from mmnn_sts_tpu.config import parse_config as jax_parse_config
    from mmnn_sts_tpu.models import build_model as jax_build_model
    from mmnn_sts_tpu.train.checkpoint import load_params_npz
    import jax
    import jax.numpy as jnp

    got_path = runs["port"] / "out" / "best_surv_model.npz"
    with np.load(got_path) as g, \
            np.load(runs["jax"] / "out" / "best_surv_model.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for k in g.files:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    model = jax_build_model(jax_parse_config(str(runs["config"])), True,
                            True, False, True)
    variables = jax.eval_shape(model.init, jax.random.key(1), {
        "image": jnp.zeros((1,) + (SIDE,) * 3 + (2,)),
        "clinical": jnp.zeros((1, 11))})
    params, stats = load_params_npz(str(got_path), variables["params"],
                                    variables["batch_stats"])
    with np.load(runs["init"]) as init:
        moved = init["params/output_head/kernel"]
    assert not np.array_equal(np.asarray(params["output_head"]["kernel"]),
                              moved)  # trained, not the init


def test_blend_history_matches_jax(runs):
    got = np.loadtxt(runs["port"] / "out" / "gblend_weights_history.csv",
                     delimiter=",")
    want = np.loadtxt(runs["jax"] / "out" / "gblend_weights_history.csv",
                      delimiter=",")
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    for name in ("train_val_loss.png", "train_val_c_score.png"):
        assert (runs["port"] / "out" / name).exists()


def test_export_path_serves_the_trained_weights(runs, tmp_path):
    from mmnn_sts_torch.convert import to_jax_flat
    from mmnn_sts_torch.infer.export import ServingModel

    best = runs["port"] / "out" / "best_surv_model.npz"
    cfg = json.loads(runs["config"].read_text())
    cfg["Hyperparameters"]["model_weights"] = str(best)
    config = tmp_path / "trained.json"
    config.write_text(json.dumps(cfg))
    artifact = tmp_path / "model.pt"
    rc = _in_dir(port_main, RUN + ["--config", str(config), "--device", "cpu",
                                   "--export_path", str(artifact),
                                   "--output_path", str(tmp_path)], tmp_path)
    assert rc == 0
    server = ServingModel(str(artifact), device="cpu")
    flat = to_jax_flat(server.model.state_dict())
    with np.load(best) as data:
        assert sorted(data.files) == sorted(flat)
        assert all(np.array_equal(data[k], flat[k]) for k in data.files)
    rng = np.random.default_rng(0)
    out = server({"image": (rng.normal(size=(3,) + (SIDE,) * 3 + (2,)) ** 2
                            * 500).astype(np.float32),
                  "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
    assert out.shape == (3, 2) and np.isfinite(out).all()


def test_resume_carries_the_step_on(runs):
    from mmnn_sts_torch.train.checkpoint import CheckpointManager

    ck = runs["port"] / "ck"
    manager = CheckpointManager(str(ck))
    assert manager.latest_step() == 2
    before = torch.load(ck / "ckpt_00000002.pt", weights_only=True)
    history = runs["port"] / "out" / "gblend_weights_history.csv"
    blend_before = np.loadtxt(history, delimiter=",")
    rc = _in_dir(port_main, runs["common"] + [
        "--epochs", "3", "--device", "cpu", "--resume", "--checkpoint_dir",
        str(ck), "--output_path", str(runs["port"] / "out")], runs["port"])
    assert rc == 0
    assert manager.latest_step() == 3
    after = torch.load(ck / "ckpt_00000003.pt", weights_only=True)
    spe = before["step"] // 2
    assert spe >= 1 and after["step"] == 3 * spe and after["epoch"] == 3
    rows = _rows(runs["port"] / "out")
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    # the resumed run rewrites the whole history: the initial weights and
    # one update an epoch, the first three as the first run wrote them
    blend_after = np.loadtxt(history, delimiter=",")
    assert blend_after.shape == (4, blend_before.shape[1])
    np.testing.assert_array_equal(blend_after[:3], blend_before)


@pytest.mark.parametrize("flag", ["--segmentation"])
def test_unported_flags_raise(flag):
    """The port's twin of the JAX package's test_cli_segmentation_raises
    (tests/test_streaming.py:72-77): both CLIs refuse the flag before they
    read the config, the port naming its own cohort builder."""
    from mmnn_sts_tpu.cli import main as jax_main

    argv = [flag, "--config", "/nonexistent.yaml"]
    with pytest.raises(NotImplementedError, match="segmentation") as jax_err:
        jax_main(argv)
    with pytest.raises(NotImplementedError, match="segmentation") as err:
        port_main(argv)
    assert str(err.value) == str(jax_err.value).replace(
        "mmnn_sts_tpu.", "mmnn_sts_torch.")
    assert "mmnn_sts_torch.data.images.build_segmentation_cohort" in str(
        err.value)


def test_without_cuda_the_cli_raises(runs, tmp_path):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _in_dir(port_main, runs["common"] + [
                "--output_path", str(tmp_path)], tmp_path)
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_json_config_parses_the_same_in_both_packages(tmp_path):
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_tpu.config import parse_config as jax_parse_config

    raw = {"Data": {"data_loc": "c.csv", "t1_path": "T1"},
           "ImageModel": {"name": "densenet121", "modality": "t1t2",
                          "in_channels": 2, "spatial_size": [64, 64, 64],
                          "dropout_prob": 0.1},
           "ClinicalModel": {"PRE_OP_PREDICTORS": ["Age", "Sex"],
                             "standardize": True},
           "Preprocessing": {"HEADER_PAIRS": [["VitalStatus", "FUtime"]],
                             "train_uid_location": "t.txt"},
           "Hyperparameters": {"epochs": 3, "learning_rate": 0.01,
                               "cox_ties": "efron"},
           "TPU": {"eval_chunk_size": 8, "profile_dir": "prof"}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    got = dataclasses.asdict(parse_config(str(path)))
    want = dataclasses.asdict(jax_parse_config(str(path)))
    for section, fields in got.items():
        for name, value in fields.items():
            assert value == want[section][name], (section, name)
    assert got["preprocessing"]["header_pairs"] == [("VitalStatus", "FUtime")]


def test_cli_runs_without_pandas_yaml_or_jax(runs, tmp_path):
    """``python -m mmnn_sts_torch`` (runpy, as the interpreter runs it) with
    the blocked packages: the PNG curves are not drawn, everything else
    is written."""
    args = RUN[:-3] + ["1", "--config", str(runs["config"]), "--device",
                       "cpu", "--output_path", str(tmp_path / "out")]
    run_blocked(
        "import runpy\n"
        f"sys.argv = ['mmnn_sts_torch'] + {args!r}\n"
        "try:\n"
        "    runpy.run_module('mmnn_sts_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "print('ok')\n",
        str(tmp_path))
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["best_surv_model.npz",
                                       "gblend_weights_history.csv",
                                       "metrics.jsonl"]


def test_two_ranks_under_torch_distributed_run(runs, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2`` runs the CLI
    on the CPU (two gloo ranks of the ``data`` axis), each rank with
    pandas, matplotlib, yaml and jax blocked: rc 0, both ranks log gloo,
    rank 0 alone writes (one metrics row an epoch, the uid files as the
    one-process run writes them), and the losses lie within 2e-2 of the
    one-process run's (the ranks sum the BatchNorm statistics and the
    gradients in another order; one-ulp changes move the survival loop's
    losses by up to 1.3e-2 over 3 epochs, ROADMAP.md Queue 3)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(
        BLOCK_PRELUDE + "import runpy\n"
        "sys.argv = ['mmnn_sts_torch'] + sys.argv[1:]\n"
        "runpy.run_module('mmnn_sts_torch', run_name='__main__')\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None\n"
        "             and k.split('.')[0] in ('jax', 'flax', 'pandas',\n"
        "                                     'matplotlib', 'yaml'))\n"
        "assert not bad, bad\n")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "2", "--master_addr", "localhost",
         "--master_port", str(port), str(script)] + runs["common"] + [
            "--output_path", "out", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO, os.path.join(REPO, "tests")])})
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    logged = sorted(line for line in res.stdout.splitlines()
                    if line.startswith("distributed:"))
    assert logged == [f"distributed: rank {r} of 2, backend gloo, device "
                      "cpu" for r in range(2)]
    # the one-process run's first two rows (a later test resumes it)
    got, want = _rows(tmp_path / "out"), _rows(runs["port"] / "out")[:2]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for name in ("train_uids.txt", "val_uids.txt", "test_uids.txt"):
        assert (tmp_path / name).read_text() == \
            (runs["port"] / name).read_text()
    worst = max(abs(g[key] - w[key]) / max(1.0, abs(w[key]))
                for g, w in zip(got, want)
                for key in ("train_loss", "val_loss", "selection_loss"))
    print(f"two ranks vs one process: losses within {worst:.2e}")
    assert worst <= 2e-2
