"""A profiled window, reduced to what the per-layer metrics read.

``Trace.from_profiler`` takes a stopped ``torch.profiler.profile`` and the
name of the range that marks the window (a ``record_function`` the harness
opened around it), and keeps, inside that window:

* ``device``: every operation that ran on the card (kernels, memory
  copies, memsets) as (name, start, end) in seconds on the trace's clock;
* ``host``: the CPU ranges of the window's thread (torch operators,
  CUDA runtime calls, annotations) as (name, start, end).

From these: ``busy_s`` is the union of the device intervals (not their
sum: kernels of two streams, or a copy under a kernel, count once);
``gaps`` are the idle stretches between them; ``device_s(match)`` sums
the device time of the operations whose name matches; ``breakdown`` lists
the device operations that took most time, and the idle time by what the
host was doing when it began (the innermost host range open at the gap's
middle).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SHORT_GAP_S = 50e-6
NAME_CHARS = 160


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


@dataclasses.dataclass
class Trace:
    start: float
    end: float
    device: list  # (name, start, end)
    host: list  # (name, start, end)

    @classmethod
    def from_profiler(cls, prof, window_range: str) -> "Trace":
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == window_range
                 and e.device_type() == DeviceType.CPU]
        if not marks:
            raise ValueError(f"no {window_range!r} range in the trace")
        mark = marks[0]
        t0 = mark.start_ns()
        t1 = t0 + mark.duration_ns()
        thread = mark.start_thread_id()
        device, host = [], []
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if s + d <= t0 or s >= t1:
                continue
            if e.device_type() == DeviceType.CUDA:
                # kernels, copies and memsets; a range the profiler mirrors
                # on the device's timeline is not an operation
                if not _annotation(e):
                    device.append((e.name(), max(s, t0) * 1e-9,
                                   min(s + d, t1) * 1e-9))
            elif e.start_thread_id() == thread and e.name() != window_range:
                host.append((e.name(), s * 1e-9, (s + d) * 1e-9))
        return cls(t0 * 1e-9, t1 * 1e-9, device, host)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def _merged(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device intervals as sorted (starts, ends)."""
        if not self.device:
            return np.zeros(0), np.zeros(0)
        s = np.array([d[1] for d in self.device])
        e = np.array([d[2] for d in self.device])
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = e[np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]]
        return starts, ends

    def busy_s(self) -> float:
        starts, ends = self._merged()
        return float(np.sum(ends - starts))

    def gaps(self) -> list[tuple[float, float]]:
        """Idle (start, end) stretches of the window."""
        starts, ends = self._merged()
        edges_s = np.r_[self.start, ends]
        edges_e = np.r_[starts, self.end]
        keep = edges_e > edges_s
        return list(zip(edges_s[keep].tolist(), edges_e[keep].tolist()))

    def device_s(self, match) -> tuple[float, int]:
        """(seconds, count) of the device operations whose name satisfies
        ``match``."""
        total, count = 0.0, 0
        for name, s, e in self.device:
            if match(name):
                total += e - s
                count += 1
        return total, count

    def host_at(self, times) -> list[str]:
        """The innermost host range open at each of the sorted ``times``."""
        spans = sorted(self.host, key=lambda h: (h[1], -h[2]))
        out, stack, i = [], [], 0
        for t in times:
            while i < len(spans) and spans[i][1] <= t:
                while stack and stack[-1][2] < spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            out.append(stack[-1][0] if stack else
                       "host outside any torch range (Python)")
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.device:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = self.gaps()
        long_gaps = [g for g in gaps if g[1] - g[0] >= SHORT_GAP_S]
        labels = self.host_at([(s + e) / 2 for s, e in long_gaps])
        idle: dict[str, float] = {}
        for (s, e), label in zip(long_gaps, labels):
            key = f"host in {label[:NAME_CHARS]}"
            idle[key] = idle.get(key, 0.0) + (e - s)
        short = sum(e - s for s, e in gaps if e - s < SHORT_GAP_S)
        if short:
            idle["gaps under 50 us between device operations"] = short
        gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gap_list]}
