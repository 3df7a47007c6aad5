"""Spans, counters and device phase stamps of the training run.

**Host spans.** ``span(name)`` is a context manager that records its name,
start and end (``time.perf_counter_ns``), the enclosing span of its thread
as parent, its thread and the loop's epoch. ``epoch(index)`` is the loop's
epoch span: while it is open ``index`` is the current epoch, and it starts
that epoch's record anew. While a ``torch.profiler`` runs (checked at each
span's start), a span also opens ``torch.profiler.record_function(name)``,
so it lies in the profiler's trace on the clock of the device operations;
without one a span costs two clock reads and an append. A profiler that
stops while a span is open ends nothing here.

**Counters.** ``count(name, n)`` adds ``n`` to the current epoch's counter.

**Device phase stamps.** A CUDA graph replays a step's kernels but none of
the host's ranges, so a step body marks its own phases on the device. Run
inside a ``Stamper``, the body calls ``mark(phase)`` at the end of each
phase; each mark launches a one-thread kernel (``kernels/csrc/
span_stamp.cu``) that writes the device's global timer (ns) into the
stamper's row of a ``PhaseRows`` buffer. The row is read on the device from
a slot tensor, so every replay of a captured body writes its own row with
no host work; a slot outside the rows writes nothing. A buffer holds as
many stamps a row as its bodies write (``width``). On the CPU the same
call writes ``time.perf_counter_ns()``, exact there since CPU operations
run synchronously. Consecutive stamps
bound the phases: a mark's phase runs from the stamp before it to its own.
The code that runs the bodies notes each ``PhaseRows`` it wrote with
``stamped(rows)``; ``stamps()`` copies the noted rows to the host into the
current epoch's record. Call it after a read-back has synchronised, so the
copy waits for nothing.

The store is in memory: one record per epoch, each with at most
``MAX_ENTRIES`` spans and as many phase rows. ``records()`` reads it,
``reset()`` clears it and ``write_jsonl`` writes it, one epoch a line.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import json
import threading
import time

import torch

MAX_ENTRIES = 256
MAX_NOTED = 8  # PhaseRows noted between two stamps(): an epoch's and a few

_lock = threading.Lock()
_store: dict = {}
_current = [None]  # the loop's current epoch
# per thread: .spans the open spans, .stampers the active stampers,
# .stamped the PhaseRows written since the last stamps()
_local = threading.local()


def _new_record() -> dict:
    return {"spans": [], "counts": {}, "phases": []}


def _record(epoch) -> dict:
    rec = _store.get(epoch)
    if rec is None:
        rec = _store[epoch] = _new_record()
    return rec


def _open(name: str) -> list:
    stack = getattr(_local, name, None)
    if stack is None:
        stack = []
        setattr(_local, name, stack)
    return stack


def current_epoch():
    """The loop's current epoch (None outside an epoch span)."""
    return _current[0]


class Span:
    """One host span; see the module docstring. ``elapsed_s()`` reads an
    open span."""

    __slots__ = ("name", "epoch", "parent", "start_ns", "end_ns", "_range",
                 "_begins_epoch")

    def __init__(self, name: str, epoch=None, begins_epoch: bool = False):
        self.name, self.epoch = name, epoch
        self._begins_epoch = begins_epoch
        self.parent = self._range = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        if self._begins_epoch:
            _current[0] = self.epoch
            with _lock:
                _store[self.epoch] = _new_record()
        elif self.epoch is None:
            self.epoch = _current[0]
        stack = _open("spans")
        self.parent = stack[-1].name if stack else None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def elapsed_s(self) -> float:
        return (time.perf_counter_ns() - self.start_ns) * 1e-9

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        stack = _open("spans")
        if self in stack:
            stack.remove(self)
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except Exception:  # noqa: BLE001 - the profiler stopped meanwhile
                pass
        entry = {"name": self.name, "start_ns": self.start_ns,
                 "end_ns": self.end_ns, "parent": self.parent,
                 "thread": threading.current_thread().name,
                 "epoch": self.epoch}
        with _lock:
            spans = _record(self.epoch)["spans"]
            if len(spans) < MAX_ENTRIES:
                spans.append(entry)
        if self._begins_epoch and _current[0] == self.epoch:
            _current[0] = None
        return False


def span(name: str, epoch=None) -> Span:
    """A span of ``name`` in ``epoch``'s record (default: the current
    epoch's)."""
    return Span(name, epoch)


def epoch(index: int) -> Span:
    """The loop's span of epoch ``index`` (``loop.epoch``): the current
    epoch while open; ``index``'s record starts empty."""
    return Span("loop.epoch", index, begins_epoch=True)


def count(name: str, n: int = 1, epoch=None):
    """Add ``n`` to the counter ``name`` of ``epoch`` (default: the
    current epoch)."""
    e = _current[0] if epoch is None else epoch
    with _lock:
        counts = _record(e)["counts"]
        counts[name] = counts.get(name, 0) + n


# ---------------------------------------------------------------------------
# Device phase stamps
# ---------------------------------------------------------------------------


@functools.cache
def _launcher():
    """``span_stamp_launch(slot, stamps, rows, width, mark, device,
    stream)``."""
    from ..kernels import build

    fn = build.load("span_stamp").span_stamp_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def span_stamp(slot: torch.Tensor, buf: torch.Tensor, mark: int):
    """Write the device's global timer into ``buf[slot[0], mark]`` with one
    thread on the current stream (CUDA tensors: int64, ``buf`` contiguous);
    nothing where ``slot[0]`` is outside ``buf``'s rows. Counts its launches
    in ``span_stamp.launches``."""
    if slot.dtype != torch.int64 or buf.dtype != torch.int64 \
            or not buf.is_contiguous() or not 0 <= mark < buf.shape[1]:
        raise ValueError("span_stamp: int64 slot and contiguous int64 rows, "
                         f"mark in [0, {buf.shape[1]}), got mark {mark}")
    rc = _launcher()(slot.data_ptr(), buf.data_ptr(), buf.shape[0],
                     buf.shape[1], mark, buf.device.index,
                     torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span_stamp: launch failed with CUDA error {rc}")
    span_stamp.launches += 1


span_stamp.launches = 0


class PhaseRows:
    """Rows of device phase stamps, one a step: ``buf`` (int64, ``rows`` x
    ``width``, the most stamps a body writes) and, per row, the ``Stamper``
    that wrote it last."""

    def __init__(self, rows: int, device, width: int):
        self.buf = torch.zeros((rows, width), dtype=torch.int64,
                               device=device)
        self.slots = torch.arange(rows, dtype=torch.int64, device=device)
        self.writers: list = [None] * rows

    def at(self, row: int, kind: str) -> "Stamper":
        """A stamper of row ``row``, recorded as its writer."""
        stamper = Stamper(kind, self, self.slots[row:row + 1])
        self.writers[row] = stamper
        return stamper


class Stamper:
    """The stamps of one step body (``kind``) into ``rows`` at the row that
    ``slot`` (a one-element int64 tensor on the rows' device) holds when
    the stamp runs. ``phases`` names the phase of each stamp after the
    first, as the body's last run on the host marked them."""

    def __init__(self, kind: str, rows: PhaseRows, slot: torch.Tensor):
        self.kind, self.rows, self.slot = kind, rows, slot
        self.phases: tuple = ()
        self._marks: list = []

    def __enter__(self) -> "Stamper":
        self._marks = []
        _open("stampers").append(self)
        self._write(0)
        return self

    def mark(self, phase: str):
        self._marks.append(phase)
        self._write(len(self._marks))

    def __exit__(self, *exc) -> bool:
        _open("stampers").pop()
        if exc[0] is None:
            self.phases = tuple(self._marks)
        return False

    def _write(self, k: int):
        buf = self.rows.buf
        if buf.is_cuda:
            span_stamp(self.slot, buf, k)
        elif 0 <= (row := int(self.slot[0])) < buf.shape[0]:
            buf[row, k] = time.perf_counter_ns()


def mark(phase: str):
    """End the phase ``phase`` of the step body being stamped on this
    thread; nothing outside a ``Stamper``."""
    stack = getattr(_local, "stampers", None)
    if stack:
        stack[-1].mark(phase)


def stamped(rows: PhaseRows):
    """Note ``rows`` as written, for the next ``stamps()`` of this
    thread."""
    noted = _open("stamped")
    if not any(r is rows for r in noted):
        noted.append(rows)
        del noted[:-MAX_NOTED]


def stamps():
    """Copy the rows noted on this thread since the last call into the
    current epoch's record: per row its ``kind``, ``slot``, the ``marks``
    (ns) and their ``phases``."""
    noted = _open("stamped")
    rows, noted[:] = list(noted), []
    entries = []
    for r in rows:
        host = r.buf.cpu().tolist()
        for slot, writer in enumerate(r.writers):
            if writer is not None and writer.phases:
                entries.append({"kind": writer.kind, "slot": slot,
                                "marks": host[slot][:len(writer.phases) + 1],
                                "phases": list(writer.phases)})
    with _lock:
        phases = _record(_current[0])["phases"]
        phases.extend(entries[:max(0, MAX_ENTRIES - len(phases))])


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


def records() -> dict:
    """A copy of the store: epoch -> ``{"spans", "counts", "phases"}``."""
    with _lock:
        return copy.deepcopy(_store)


def reset():
    """Clear the store, and the rows this thread noted for ``stamps()``."""
    with _lock:
        _store.clear()
    _current[0] = None
    _open("stamped").clear()


def write_jsonl(path: str, epochs=None):
    """Write the records of ``epochs`` (default: all) to ``path``, one
    epoch a line (``{"epoch": e, "spans", "counts", "phases"}``)."""
    recs = records()
    keys = [e for e in recs if epochs is None or e in epochs]
    with open(path, "w") as f:
        for e in sorted(keys, key=lambda k: (k is None, k or 0)):
            f.write(json.dumps({"epoch": e, **recs[e]}) + "\n")
