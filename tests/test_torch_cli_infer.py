"""``python -m mmnn_sts_torch --inference`` held against the JAX package's
CLI.

One cohort (40 patients of ``tests/fixtures.make_full_cohort``, TinyDenseNet
at 32^3 x 2ch, whose last block is 2^3, so the attention maps are not
trivially 0) and one set of weights shared by both packages through the
config's ``model_weights``: the port registry model's init from seed 0 in
the JAX key scheme, its output head's kernel scaled by 8 and its bias set
to (1, -1), so that no probability lies within 1e-3 of the threshold
(checked: a label on the edge could flip on roundoff, and the label names
the attention directory). Both CLIs split the cohort anew (``--split``,
seed 42) and run on its test split; the JAX CLI in a one-device subprocess.

* ``--inference --survival --blend --bootstrap`` with Grad-CAM: the same
  ``_patient_{uid}`` directories, each att_map within 1e-4 of JAX's, the
  bootstrap's means and stds within 1e-6 (JAX's as it logs them).
* ``--inference --classification --blend`` with Grad-CAM: the same
  model_probabilities.csv (uids and labels exactly, probabilities within
  1e-5) and the same ``{correct}_{labels}_{preds}__patient_{uid}``
  directories.
* The survival predictions CSV without ``--bootstrap``: uids, events and
  durations exactly, predictions within 1e-5 relative (the scaled head
  makes them ~10-70).
* ``--device cuda`` without a card raises before anything is written.
"""

import gzip
import json
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from fixtures import make_full_cohort
from mmnn_sts_torch.cli import main as port_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COHORT, SIDE = 40, 32
SURVIVAL = ["--inference", "--images", "--preop", "--survival", "--blend",
            "--split"]
CLASSIFICATION = ["--inference", "--images", "--preop", "--classification",
                  "--blend", "--split"]

# the JAX CLI on one CPU device, with the suite's compile cache
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


def run_jax_cli(args, workdir) -> str:
    """The JAX CLI's stdout (its log)."""
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}
    res = subprocess.run(
        [sys.executable, "-c", JAX_CLI, os.path.join(REPO, ".jax_cache")]
        + args, cwd=workdir, env=env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


def run_port_cli(args, workdir):
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return port_main(args + ["--device", "cpu"])
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("cli_infer")
    paths, _ = make_full_cohort(str(root), n=N_COHORT)
    cfg = {"Data": {"data_loc": paths["clinical"], "image_loc": paths["root"],
                    "key_loc": paths["key"]},
           "ImageModel": {"name": "tinydensenet",
                          "spatial_size": [SIDE] * 3},
           "Hyperparameters": {"seed": 42,
                               "model_weights": str(root / "weights.npz")}}
    config = root / "config.json"
    config.write_text(json.dumps(cfg))
    torch.manual_seed(0)
    model = build_model(parse_config(str(config)), True, True, False, True)
    with torch.no_grad():
        model.output_head.weight.mul_(8.0)
        model.output_head.bias.copy_(torch.tensor([1.0, -1.0]))
    save_params_npz(str(root / "weights.npz"), model)
    return dict(root=root, config=config)


def _both(cohort, name, args):
    """Run ``args`` through both CLIs in their own directories; returns
    (JAX log, port's inference result, the two output directories)."""
    dirs = {side: cohort["root"] / f"{name}_{side}" for side in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    common = args + ["--config", str(cohort["config"]), "--output_path"]
    log = run_jax_cli(common + [str(dirs["jax"] / "out")], dirs["jax"])
    from mmnn_sts_torch.infer import run as infer_run

    results = []

    def keep(fn):
        def call(*a, **kw):
            results.append(fn(*a, **kw))
            return results[-1]
        return call

    with mock.patch.object(infer_run, "inference_survival",
                           keep(infer_run.inference_survival)), \
            mock.patch.object(infer_run, "inference_classification",
                              keep(infer_run.inference_classification)):
        assert run_port_cli(common + [str(dirs["port"] / "out")],
                            dirs["port"]) == 0
    (result,) = results
    return log, result, {k: d / "out" for k, d in dirs.items()}


@pytest.fixture(scope="module")
def survival(cohort):
    return _both(cohort, "survival", SURVIVAL + ["--bootstrap"])


@pytest.fixture(scope="module")
def classification(cohort):
    return _both(cohort, "classification", CLASSIFICATION)


def _logged(log, what):
    m = re.search(re.escape(what) + r": \[([^\]]*)\]", log)
    assert m, what
    return np.array([float(v) for v in m.group(1).split()])


def _nifti(path):
    with gzip.open(path, "rb") as f:
        blob = f.read()
    return np.frombuffer(blob[352:], np.float32)


def _att_dirs(out):
    return sorted(os.listdir(out / "attention_maps"))


def test_survival_bootstrap_matches_jax(survival):
    log, got, _ = survival
    assert 0 < got["resample_c"].shape[0] <= 50
    np.testing.assert_allclose(got["mean_c"], _logged(log, "Mean c indices"),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["std_c"], _logged(log, "Std. devs"),
                               rtol=0, atol=1e-6)


def test_survival_attention_maps_match_jax(survival):
    _, _, out = survival
    dirs = _att_dirs(out["port"])
    assert dirs == _att_dirs(out["jax"]) and len(dirs) >= 4
    assert all(re.fullmatch(r"_patient_\d+", d) for d in dirs)
    for d in dirs:
        files = sorted(os.listdir(out["port"] / "attention_maps" / d))
        assert files == sorted(os.listdir(out["jax"] / "attention_maps" / d))
        for name in ("att_map.nii.gz", "att_map_cls1.nii.gz"):
            got = _nifti(out["port"] / "attention_maps" / d / name)
            want = _nifti(out["jax"] / "attention_maps" / d / name)
            assert got.size == SIDE ** 3 and want.max() > 0.5
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _read_csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")]
                               for line in lines[1:]])


def test_classification_inference_matches_jax(classification):
    _, got, out = classification
    header, port = _read_csv(out["port"] / "model_probabilities.csv")
    jheader, jax_rows = _read_csv(out["jax"] / "model_probabilities.csv")
    assert header == jheader == "0,1,2,3,4"
    assert port.shape == jax_rows.shape and len(port) >= 4
    np.testing.assert_array_equal(port[:, [0, 3, 4]], jax_rows[:, [0, 3, 4]])
    np.testing.assert_allclose(port[:, 1:3], jax_rows[:, 1:3], rtol=0,
                               atol=1e-5)
    assert np.abs(jax_rows[:, 1:3] - 0.5).min() > 1e-3  # no label on the edge
    dirs = _att_dirs(out["port"])
    assert dirs == _att_dirs(out["jax"]) and len(dirs) == len(port)
    for d in dirs:
        assert re.fullmatch(r"[01]{2}_[01]{2}_[01]{2}__patient_\d+", d)
        assert "probabilities.txt" in os.listdir(
            out["port"] / "attention_maps" / d)
    np.testing.assert_allclose(got["probs"], port[:, 1:3], rtol=0, atol=1e-7)


def test_survival_predictions_csv_matches_jax(cohort):
    _, got, out = _both(cohort, "survival_csv", SURVIVAL + ["--no_gradcam"])
    header, port = _read_csv(out["port"] / "survival_model_predictions.csv")
    jheader, jax_rows = _read_csv(
        out["jax"] / "survival_model_predictions.csv")
    assert header == jheader
    np.testing.assert_array_equal(port[:, [0, 3, 4, 5, 6]],
                                  jax_rows[:, [0, 3, 4, 5, 6]])
    np.testing.assert_allclose(port[:, 1:3], jax_rows[:, 1:3], rtol=1e-5,
                               atol=1e-5)
    assert not os.path.exists(out["port"] / "attention_maps")
    assert len(got["c_indices"]) == 2


def test_inference_without_cuda_raises(cohort, tmp_path):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(SURVIVAL + ["--config", str(cohort["config"]),
                                  "--output_path", str(tmp_path / "out"),
                                  "--device", "cuda"])
    assert not os.path.exists(tmp_path / "out" / "attention_maps")
