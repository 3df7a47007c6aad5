"""A run end to end on the CPU (the harness's look for a card skipped):
the result line, a run without a card or without the program, and the
planted faults and the control that ``correct`` has to catch."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run as bench
from perfbench.cells import resolve
from perfbench.tests.conftest import REPO, write_tiny_root

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_traced_result_has_exactly_the_contract_keys(tiny_result):
    assert list(tiny_result) == CONTRACT + ["breakdown", "checks"]
    assert set(tiny_result["device"]) == {
        "platform", "kind", "count", "memory_peak_bytes", "busy_s",
        "window_s"}
    assert set(tiny_result["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in tiny_result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in tiny_result["checks"].values():
        assert set(c) == {"value", "limit"}
    assert tiny_result["correct"] is True
    assert tiny_result["failed"] == 0 and tiny_result["attempted"] >= 4
    json.dumps(tiny_result)


def test_untraced_result_reports_the_end_to_end_metrics(tiny_root):
    result = bench.measure(resolve("tiny.mix", tiny_root), 99, 0.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert list(result) == CONTRACT + ["checks"]
    assert set(result["metrics"]) == {"train_volumes_per_s",
                                      "peak_mem_gib", "setup_s"}
    assert result["metrics"]["train_volumes_per_s"]["value"] > 0


def _no_result(proc):
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    return proc.returncode != 0 and not lines


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "dn121_mmnn.train_fused_bf16", "--seed", str(2 ** 40), "--seconds",
         "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert _no_result(proc)
    assert "no CUDA card" in proc.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone: the program is
    missing, so the run fails (here on the CPU, past the card's look)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import time, torch; from perfbench import run, cells; "
            "run.measure(cells.resolve('dn121_mmnn.train_fused_bf16'), 1, "
            "0.0, False, torch.device('cpu'), time.perf_counter())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert _no_result(proc)
    assert "No module named 'mmnn_sts_torch'" in proc.stderr


def _state_unchanged(monkeypatch):
    from mmnn_sts_torch.train.state import TrainState

    def no_update(self):
        self.step_t += 1

    monkeypatch.setattr(TrainState, "device_update", no_update)


def _half_batch(monkeypatch):
    from mmnn_sts_torch.train import steps

    loss = steps._survival_loss

    def half(blend_state, out, events, durations, blend, ties, mask=None):
        b = events.shape[0] // 2
        return loss(blend_state, out[:, :b] if blend else out[:b],
                    events[:b], durations[:b], blend, ties,
                    None if mask is None else mask[:b])

    monkeypatch.setattr(steps, "_survival_loss", half)


def _answer_altered(monkeypatch):
    from mmnn_sts_torch.train import steps

    body = steps._survival_eval_body

    def negated(*args):
        out = body(*args)
        preds = out["preds"].clone()
        preds[..., 0, :] = -preds[..., 0, :]
        return {**out, "preds": preds}

    monkeypatch.setattr(steps, "_survival_eval_body", negated)


def _tail_unmasked(monkeypatch):
    from mmnn_sts_torch.train import steps

    body = steps._superstep_body

    def unmasked(*args):
        return body(*args[:-1], None)

    monkeypatch.setattr(steps, "_superstep_body", unmasked)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _answer_altered, _tail_unmasked])
@pytest.mark.parametrize("limits_of", ["dn121_mmnn.train_fused_bf16",
                                       "dn121_mmnn.train_fused_fp32"])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, plant,
                                      limits_of):
    name = write_tiny_root(tmp_path, limits_of)
    plant(monkeypatch)
    result = bench.measure(resolve(name, tmp_path), 5, 0.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False, result["checks"]
