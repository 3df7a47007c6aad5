"""The port's spans, counters and device phase stamps (``utils/tracing.py``)
on the CPU: spans nest, the training loops leave one record an epoch with
every loop phase and a stamped row for every step (tail and validation
forward included), the spans open profiler ranges only under a profiler,
and ``TPU.profile_dir`` profiles the first steady epoch and writes
``spans.jsonl``. A small TinyCNN blend model at 16^3, three epochs.
"""

import json

import numpy as np
import pytest
import torch

from mmnn_sts_torch.data.loader import build_device_dataset
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.models.tinycnn import TinyCNN
from mmnn_sts_torch.train.loop import (
    LoopConfig, train_classification, train_survival)
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.utils import tracing

SIDE, P, EPOCHS = 16, 11, 3
# survival: supersteps of 2 x 2, 10 samples = two full supersteps and a
# masked tail; classification: batches of 4, 10 samples = two and a tail
N, N_VAL = 10, 5
LOOP_PHASES = {"loop.log", "loop.dispatch", "loop.readback",
               "loop.train_metrics", "loop.validation", "loop.blend_update",
               "loop.checkpoint"}


@pytest.fixture(autouse=True)
def _fresh_store():
    tracing.reset()
    yield
    tracing.reset()


def _split(seed, n, survival):
    rng = np.random.default_rng(seed)
    arrays = {"image_volumes": (rng.normal(size=(n,) + (SIDE,) * 3 + (2,))
                                ** 2 * 500).astype(np.float32),
              "clinical": rng.normal(size=(n, P)).astype(np.float32)}
    if survival:
        arrays["events"] = (rng.random((n, 2)) < 0.7).astype(np.float32)
        arrays["durations"] = rng.integers(1, 4, (n, 2)).astype(np.float32)
    else:
        arrays["labels"] = (rng.random((n, 2)) < 0.5).astype(np.float32)
    return build_device_dataset(np.arange(n), "cpu", **arrays)


def _run(tmp_path, survival=True, fused=True, n=N, **kw):
    torch.manual_seed(0)
    encoder = TinyCNN(in_channels=2, out_channels=None, feature_channels=4,
                      dropout_prob=0.2)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=0.2)
    opt, sched = make_optimizer(model.parameters(), 1e-3, 3, EPOCHS)
    state = create_train_state(model, opt, sched, seed=0)
    cfg = LoopConfig(**{**dict(
        epochs=EPOCHS, batch_size=2 if survival else 4, super_batch=4,
        blend=True, blend_update_interval=1, output_dir=str(tmp_path),
        save_params_name="best.npz", fused_epoch=fused), **kw})
    train = train_survival if survival else train_classification
    train(state, _split(1, n, survival), _split(2, N_VAL, survival), cfg)
    return tracing.records()


def _ms(s):
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def test_spans_nest_with_their_parents():
    with tracing.epoch(7) as e:
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.count("n", 3)
            tracing.count("n")
        with tracing.span("c", epoch=8):
            pass
        assert e.elapsed_s() >= 0
    with tracing.span("outside"):
        pass
    recs = tracing.records()
    spans = {s["name"]: s for s in recs[7]["spans"]}
    assert {k: s["parent"] for k, s in spans.items()} == {
        "b": "a", "a": "loop.epoch", "loop.epoch": None}
    assert spans["a"]["start_ns"] <= spans["b"]["start_ns"] \
        <= spans["b"]["end_ns"] <= spans["a"]["end_ns"]
    assert recs[7]["counts"] == {"n": 4}
    assert [s["parent"] for s in recs[8]["spans"]] == ["loop.epoch"]
    assert [s["name"] for s in recs[None]["spans"]] == ["outside"]
    assert tracing.current_epoch() is None


def test_reset_forgets_the_rows_noted_before_it():
    rows = tracing.PhaseRows(1, "cpu", 2)
    with rows.at(0, "step"):
        tracing.mark("gather")
    tracing.stamped(rows)
    tracing.reset()
    with tracing.epoch(0):
        tracing.stamps()
    assert tracing.records()[0]["phases"] == []
    tracing.stamped(rows)
    with tracing.epoch(1):
        tracing.stamps()
    (row,) = tracing.records()[1]["phases"]
    assert row["phases"] == ["gather"] and row["kind"] == "step"


def _check_records(recs, survival):
    assert sorted(recs) == list(range(EPOCHS))
    micro = 2 if survival else 1
    want_phases = (["gather", "optimizer"]
                   + ["augment", "forward", "backward"] * micro
                   + ["optimizer"])
    for e, rec in recs.items():
        main = [s for s in rec["spans"] if s["thread"] == "MainThread"]
        (epoch,) = [s for s in main if s["name"] == "loop.epoch"]
        names = {s["name"] for s in main}
        assert LOOP_PHASES <= names, (e, names)
        for s in main:
            assert s["epoch"] == e and _ms(s) >= 0
            if s is not epoch:
                assert s["parent"] == "loop.epoch"
                assert epoch["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= epoch["end_ns"]
        rows = rec["phases"]
        assert [r["kind"] for r in rows] == ["step", "step", "tail", "val"]
        assert [r["slot"] for r in rows] == [0, 1, 2, 0]
        for r in rows:
            marks = np.array(r["marks"])
            assert len(marks) == len(r["phases"]) + 1
            assert (np.diff(marks) >= 0).all() and marks[0] > 0
            assert r["phases"] == (["val_forward"] if r["kind"] == "val"
                                   else want_phases)
    # the first epoch always improves: its best weights are written by the
    # saver's thread, in that epoch's record
    first = recs[0]
    assert "loop.best_save" in {s["name"] for s in first["spans"]}
    assert first["counts"]["saver.bytes"] > 0
    (write,) = [s for s in first["spans"] if s["name"] == "saver.write"]
    assert write["thread"] != "MainThread" and write["parent"] is None


@pytest.mark.parametrize("survival", [True, False],
                         ids=["survival", "classification"])
def test_loop_records_every_phase_and_step(tmp_path, survival):
    recs = _run(tmp_path, survival)
    _check_records(recs, survival)
    # epoch_seconds is the epoch span read after the train metrics
    kind = "survival_epoch" if survival else "classification_epoch"
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in logged] == [kind] * EPOCHS
    for r, e in zip(logged, range(EPOCHS)):
        spans = {s["name"]: s for s in recs[e]["spans"]}
        assert _ms(spans["loop.train_metrics"]) <= 1e3 * r["epoch_seconds"] \
            <= _ms(spans["loop.epoch"])


def test_eager_loop_stamps_every_superstep(tmp_path):
    recs = _run(tmp_path, fused=False)
    for rec in recs.values():
        assert [r["kind"] for r in rec["phases"]] == ["step", "step", "tail"]
        assert {"loop.dispatch", "loop.validation"} <= {
            s["name"] for s in rec["spans"]}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_a_row_holds_every_microbatch_of_a_long_superstep(tmp_path, fused):
    """A row is as wide as its body's stamps: one superstep of 90
    microbatches of one volume (wider than any fixed row would be) trains
    and stamps all 4 + 3 x 90 marks."""
    recs = _run(tmp_path, fused=fused, n=90, epochs=1, batch_size=1,
                super_batch=90, augment=False)
    (step,) = [r for r in recs[0]["phases"] if r["kind"] == "step"]
    assert len(step["marks"]) == 4 + 3 * 90
    assert step["phases"][-4:] == ["augment", "forward", "backward",
                                   "optimizer"]
    assert (np.diff(step["marks"]) >= 0).all()


def test_profiler_ranges_only_under_a_profiler():
    with tracing.span("loop.unprofiled") as quiet:
        pass
    assert quiet._range is None
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with tracing.epoch(0):
        with tracing.span("loop.dispatch") as loud:
            torch.ones(2).sum()
        late = tracing.span("loop.readback").__enter__()
        prof.stop()  # the profiler stops while a span is open
        late.__exit__(None, None, None)
    assert loud._range is not None
    names = {e.name for e in prof.events()}
    assert {"loop.epoch", "loop.dispatch"} <= names
    assert "loop.unprofiled" not in names
    assert "loop.readback" in {s["name"] for s in
                               tracing.records()[0]["spans"]}


def test_profile_dir_profiles_the_first_steady_epoch(tmp_path):
    """On the CPU the bodies settle in the first epoch, so the second is
    profiled (on the card: the third, after the tail's and validation's
    captures); every epoch's record lands in ``spans.jsonl``."""
    out = tmp_path / "prof"
    _run(tmp_path, profile_dir=str(out))
    assert sorted(p.name for p in out.iterdir()) == ["epoch2.json",
                                                     "spans.jsonl"]
    trace = json.loads((out / "epoch2.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert {"loop.epoch", "loop.dispatch", "loop.readback",
            "loop.validation"} <= names
    lines = [json.loads(line) for line in
             (out / "spans.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == list(range(EPOCHS))
    assert all(len(r["phases"]) == 4 and r["spans"] for r in lines)
