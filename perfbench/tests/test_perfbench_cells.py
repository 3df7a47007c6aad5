"""Cells resolve from their files, and BENCHMARK.json keeps the
contract's static rules."""

import json
import re

import pytest

from perfbench import check
from perfbench.cells import resolve
from perfbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
# the program's parameters a configuration may never reduce (widths)
WIDTHS = ("growth_rate", "bn_size", "init_features", "feature_layers",
          "in_channels", "classes", "clinical_inputs", "spatial_size")


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    fits = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert fits <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = resolve(cell, REPO)
    family = c.family()
    assert callable(family.build) and callable(family.layers)
    assert {m["name"] for m in c.end_to_end} == {
        "train_volumes_per_s", "peak_mem_gib", "setup_s"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    assert {"loss_gap", "grad_gap_median", "update_gap_median",
            "val_gap"} <= set(c.limits) <= set(check.NUMBERS)
    for v in c.limits.values():
        assert 0 < v["lower"] < v["limit"] < v["upper"]


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys
            assert NAME.match(entry["name"])
            assert entry["name"] not in names
            names.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_reduce_no_width():
    for c in BENCH["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] == []
        assert not set(c["reduced"]) & set(WIDTHS)
        assert config["source"] and config["assumed"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_a_new_cell_is_only_files(tiny_root):
    """The tiny cell lives in a temporary directory of files alone and
    resolves with the harness as it is."""
    cell = resolve("tiny.mix", tiny_root)
    assert cell.config["ImageModel"]["name"] == "tinydensenet"
    assert cell.traffic["train_patients"] == 200
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"]}


def test_a_new_cell_runs(tiny_result):
    assert tiny_result["correct"] is True
    assert "train_mfu" in tiny_result["metrics"]


def test_a_new_metric_is_a_file_and_an_entry(tmp_path):
    import types

    from perfbench.tests.conftest import write_tiny_root

    name = write_tiny_root(tmp_path)
    (tmp_path / "perfbench" / "metrics" / "window_epochs.py").write_text(
        "def read(run, cell):\n    return float(run.window_epochs)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "window_epochs", "unit": "epochs", "better": "higher",
        "source": "host_clock", "layer": "loop", "moves":
        "train_volumes_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = resolve(name, tmp_path)
    assert "window_epochs" in [m["name"] for m in cell.per_layer]
    run = types.SimpleNamespace(window_epochs=3)
    assert cell.reader("window_epochs")(run, cell) == 3.0
