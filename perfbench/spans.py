"""The per-layer metrics that read the program's own spans and device
phase stamps (``mmnn_sts_torch.utils.tracing``), over the window's epochs
alone: the loop's epochs ``warmup_epochs`` to ``warmup_epochs +
window_epochs - 1``. The traced epoch after the window and the warm-up
epochs are left out. Where the program has no such module, or no record of
one of those epochs, every reader returns None.

* ``phase_ms_per_step``: the mean over the window's full supersteps (the
  masked tail left out) of a device phase's ms, its stamped intervals
  summed over the superstep's microbatches. The stamps are the device's
  global timer (ns), written by one-thread kernels inside the captured
  step; on the CPU, the host's ``perf_counter_ns``.
* ``loop_host_ms_per_epoch``: the mean over the window's epochs of the
  ``loop.epoch`` span less its ``loop.dispatch`` and ``loop.readback``
  children: the loop's host work while the card has nothing queued.
"""

from __future__ import annotations


def window_records(run, cell) -> list | None:
    """The window's epoch records, in order, or None."""
    try:
        from mmnn_sts_torch.utils import tracing
    except ImportError:
        return None
    first = cell.traffic["warmup_epochs"]
    epochs = range(first, first + run.window_epochs)
    recs = tracing.records()
    if not epochs or any(e not in recs for e in epochs):
        return None
    return [recs[e] for e in epochs]


def phase_ms_per_step(run, cell, phase: str) -> float | None:
    recs = window_records(run, cell)
    if recs is None:
        return None
    per_step = []
    for rec in recs:
        for row in rec["phases"]:
            if row["kind"] != "step" or phase not in row["phases"]:
                continue
            marks = row["marks"]
            per_step.append(1e-6 * sum(
                marks[i + 1] - marks[i]
                for i, p in enumerate(row["phases"]) if p == phase))
    return sum(per_step) / len(per_step) if per_step else None


def loop_host_ms_per_epoch(run, cell) -> float | None:
    recs = window_records(run, cell)
    if recs is None:
        return None
    per_epoch = []
    for rec in recs:
        ms = {"loop.epoch": 0.0, "loop.dispatch": 0.0, "loop.readback": 0.0}
        seen = set()
        for s in rec["spans"]:
            if s["name"] in ms:
                ms[s["name"]] += 1e-6 * (s["end_ns"] - s["start_ns"])
                seen.add(s["name"])
        if "loop.epoch" not in seen:
            return None
        per_epoch.append(ms["loop.epoch"] - ms["loop.dispatch"]
                         - ms["loop.readback"])
    return sum(per_epoch) / len(per_epoch)
