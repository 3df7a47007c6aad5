"""The readers of the program's spans and device phase stamps
(``perfbench/spans.py``): the window's epochs alone, full supersteps
alone, and None where the program has no such records."""

import sys
import types

import pytest

from perfbench.cells import resolve
from perfbench.tests.conftest import REPO

BF16 = "dn121_mmnn.train_fused_bf16"
PHASES = ["gather", "optimizer", "augment", "forward", "backward",
          "augment", "forward", "backward", "optimizer"]


def _row(kind, slot, ms):
    """A stamped row whose phase i lasts ``ms[i]`` milliseconds."""
    marks = [1_000_000]
    for m in ms:
        marks.append(marks[-1] + int(m * 1e6))
    phases = ["val_forward"] if kind == "val" else PHASES
    return {"kind": kind, "slot": slot, "marks": marks, "phases": phases}


def _span(name, start_ms, end_ms):
    return {"name": name, "start_ns": int(start_ms * 1e6),
            "end_ns": int(end_ms * 1e6), "parent": None,
            "thread": "MainThread", "epoch": None}


def _epoch(scale):
    """An epoch's record: two full supersteps and a tail; phase times and
    host time scale with ``scale``, so another epoch reads otherwise."""
    step = [0.1, 1, 2, 10, 20, 3, 11, 21, 0.5]
    rows = [_row("step", 0, [scale * m for m in step]),
            _row("step", 1, [scale * m for m in step]),
            _row("tail", 2, [100 * m for m in step]),
            _row("val", 0, [1000])]
    spans = [_span("loop.dispatch", 0, 500), _span("loop.readback", 500, 600),
             _span("loop.train_metrics", 600, 600 + 10 * scale),
             _span("loop.epoch", 0, 600 + 30 * scale),
             _span("saver.write", 700, 5000)]
    return {"spans": spans, "counts": {}, "phases": rows}


@pytest.fixture
def records(monkeypatch):
    from mmnn_sts_torch.utils import tracing

    recs = {e: _epoch(scale) for e, scale in
            enumerate([50.0, 40.0, 1.0, 2.0, 70.0])}
    monkeypatch.setattr(tracing, "records", lambda: recs)
    return recs


def _read(metric, window_epochs=2):
    cell = resolve(BF16, REPO)
    assert cell.traffic["warmup_epochs"] == 2
    run = types.SimpleNamespace(window_epochs=window_epochs)
    return cell.reader(metric)(run, cell)


@pytest.mark.parametrize("metric,want", [
    # epochs 2 and 3 (scales 1 and 2), their full supersteps alone
    ("augment_ms_per_step", 1.5 * (2 + 3)),
    ("forward_ms_per_step", 1.5 * (10 + 11)),
    ("backward_ms_per_step", 1.5 * (20 + 21)),
    ("optimizer_ms_per_step", 1.5 * (1 + 0.5)),
    ("loop_host_ms_per_epoch", 1.5 * 30),
])
def test_readers_take_the_window_epochs(records, metric, want):
    assert _read(metric) == pytest.approx(want, rel=1e-6)


def test_window_of_one_epoch(records):
    assert _read("forward_ms_per_step", 1) == pytest.approx(21.0, rel=1e-6)
    assert _read("loop_host_ms_per_epoch", 1) == pytest.approx(30.0)


@pytest.mark.parametrize("metric", [
    "augment_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
    "optimizer_ms_per_step", "loop_host_ms_per_epoch"])
def test_none_without_records(monkeypatch, records, metric):
    from mmnn_sts_torch.utils import tracing

    del records[3]  # an epoch of the window is missing
    assert _read(metric) is None
    monkeypatch.setattr(tracing, "records", lambda: {})
    assert _read(metric) is None
    assert _read(metric, window_epochs=0) is None
    # a program without the module (the parent commit's)
    import mmnn_sts_torch.utils

    monkeypatch.delattr(mmnn_sts_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "mmnn_sts_torch.utils.tracing", None)
    assert _read(metric) is None


def test_a_phase_no_step_stamps_reads_none(records):
    for rec in records.values():
        for row in rec["phases"]:
            row["phases"] = ["val_forward" if p == "augment" else p
                             for p in row["phases"]]
    assert _read("augment_ms_per_step") is None
    assert _read("forward_ms_per_step") is not None


def test_readers_on_the_tiny_cells_run(tiny_result):
    """The tiny CPU run reports every new metric, each above 0."""
    for name in ("augment_ms_per_step", "forward_ms_per_step",
                 "backward_ms_per_step", "optimizer_ms_per_step",
                 "loop_host_ms_per_epoch"):
        assert tiny_result["metrics"][name]["value"] > 0, name
        assert tiny_result["metrics"][name]["unit"] == "ms"
