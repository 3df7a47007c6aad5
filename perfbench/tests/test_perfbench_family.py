"""A model family added by files alone: a TinyCNN blend family (the
program's multimodal ``tinycnn``, which has no fused bottleneck) in a
temporary root, as its ``reference/kinds/tinycnn_blend.py``, a
configuration, a traffic mix and a limits file, with the harness as it
is. It runs ``correct`` on the CPU, reports ``train_mfu`` from the
family's own ``layers``, and a planted half-batch fault turns ``correct``
false."""

import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import counts
from perfbench import run as bench
from perfbench.cells import resolve
from perfbench.tests.conftest import REPO, write_tiny_root
from perfbench.tests.test_perfbench_run import _half_batch

FAMILY = Path(__file__).with_name("family") / "tinycnn_blend.py"
TINYCNN = {"kind": "tinycnn_blend", "in_channels": 2, "feature_layers": 12,
           "classes": 2, "image_dropout": 0.2, "clinical_dropout": 0.2,
           "clinical_inputs": 11}


def family_root(root: Path) -> str:
    return write_tiny_root(root, model=TINYCNN, image_model="tinycnn",
                           families=[FAMILY])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinycnn")
    family_root(root)
    return root


def test_the_family_is_a_file_of_its_root(root):
    assert not (REPO / "perfbench" / "reference" / "kinds" /
                FAMILY.name).exists()
    cell = resolve("tiny.mix", root)
    family = cell.family()
    assert Path(family.__file__) == (root / "perfbench" / "reference" /
                                     "kinds" / FAMILY.name)
    assert not hasattr(family, "init_kind")  # the shared rule serves it


def test_operations_come_from_the_familys_layers(root):
    """At 16^3 the VALID convolutions leave 14^3 ... 6^3; then the feature
    layer, the clinical MLP and the three heads, by the flags."""
    cell = resolve("tiny.mix", root)
    convs = [14 ** 3 * 64 * 2, 12 ** 3 * 32 * 64, 10 ** 3 * 32 * 32,
             8 ** 3 * 16 * 32, 6 ** 3 * 16 * 16]
    image = sum(27 * m for m in convs) + 16 * 12
    clinical = 11 * 32 + 32 * 16 + 16 * 8 + 8 * 8 + 8 * 8 + 8 * 12
    heads = (2 * 12 + 12 + 12) * 2
    assert counts.forward_flops(cell) == 2.0 * (image + clinical + heads)
    first = 27 * convs[0] + 11 * 32
    assert counts.train_flops(cell) == 2.0 * (
        3 * (image + clinical + heads) - first)
    assert not any("bottleneck" in layer["name"]
                   for layer in counts.layers(cell))
    run = types.SimpleNamespace(window_s=2.0, train_volumes=400,
                                val_volumes=32)
    assert cell.reader("train_mfu")(run, cell) == pytest.approx(
        100 * (400 * counts.train_flops(cell)
               + 32 * counts.forward_flops(cell)) / 2.0
        / counts.PEAK_FLOPS[cell.traffic["mfu_peak"]])


def test_the_family_runs_correct(root):
    result = bench.measure(resolve("tiny.mix", root), 2 ** 40 + 9, 0.0,
                           True, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["train_mfu"]["value"] > 0
    for name in ("fused_fwd_roofline.bf16", "fused_fwd_roofline.fp32",
                 "batch_norm_ms_per_step"):
        assert name not in result["metrics"]  # nothing to read on the CPU


def test_half_batch_is_not_correct(tmp_path, monkeypatch):
    name = family_root(tmp_path)
    _half_batch(monkeypatch)
    result = bench.measure(resolve(name, tmp_path), 5, 0.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False, result["checks"]
