"""A tiny cell on the CPU: the real harness, configuration format and
metric readers over a three-block DenseNet at 16^3, made in a temporary
directory from files alone (a configuration, a traffic mix, a limits file
and a ``BENCHMARK.json`` naming them)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

# a few threads a test process: the tests run side by side
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = {"kind": "densenet_blend", "block_config": [6, 12, 4],
              "growth_rate": 32, "bn_size": 4, "init_features": 64,
              "in_channels": 2, "feature_layers": 12, "classes": 2,
              "image_dropout": 0.2, "clinical_dropout": 0.2,
              "clinical_inputs": 11}


def write_tiny_root(root: Path, limits_of: str = "dn121_mmnn.train_fused_fp32",
                    dtype: str = "float32", model: dict = TINY_MODEL,
                    image_model: str = "tinydensenet", families=None) -> str:
    """A benchmark root holding one tiny cell; returns its name. The cell
    is held to the limits of the repository's cell ``limits_of``. Its
    model is ``model`` (by default a three-block DenseNet blend model) at
    16^3, which the program builds as ``image_model``; the root carries
    the reference family files ``families`` (by default the
    repository's)."""
    pb = root / "perfbench"
    for sub in ("configs", "traffic", "limits", "reference/kinds"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if families is None:
        families = sorted((REPO / "perfbench" / "reference" /
                           "kinds").glob("*.py"))
    for path in families:
        shutil.copy(path, pb / "reference" / "kinds")
    config = json.loads((REPO / "perfbench" / "configs" /
                         "dn121_mmnn.json").read_text())
    config["ImageModel"].update(name=image_model, spatial_size=[16] * 3)
    config["model"] = model
    (pb / "configs" / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads((REPO / "perfbench" / "traffic" /
                          "train_fused_fp32.json").read_text())
    traffic.update(train_patients=200, val_patients=16)
    traffic["TPU"]["compute_dtype"] = dtype
    (pb / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    shutil.copy(REPO / "perfbench" / "limits" / f"{limits_of}.json",
                pb / "limits" / "tiny.mix.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.mix", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "test"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny.mix"


def config_cell(config: str):
    """A cell of the repository's configuration file ``config``, with no
    traffic or limits (``dn264_3d`` has no cell in BENCHMARK.json)."""
    from perfbench.cells import Cell

    return Cell(name=config, config=json.loads(
        (REPO / "perfbench" / "configs" / f"{config}.json").read_text()),
        traffic={}, limits={}, end_to_end=[], per_layer=[], root=REPO)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    write_tiny_root(root)
    return root


@pytest.fixture(scope="session")
def tiny_result(tiny_root):
    """One traced run of the tiny cell on the CPU, with its run record."""
    import torch

    from perfbench import run
    from perfbench.cells import resolve

    cell = resolve("tiny.mix", tiny_root)
    return run.measure(cell, 2 ** 40 + 7, 0.0, True, torch.device("cpu"),
                       time.perf_counter())
