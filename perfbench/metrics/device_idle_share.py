"""Share of the profiled epoch's wall time in which no operation ran on the
card: 1 - (the union of device intervals) / (the epoch's wall), in %."""


def read(run, cell):
    trace = run.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
