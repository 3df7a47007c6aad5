"""Device ms a superstep of the port's hand-written BatchNorm kernels
(statistics, normalise, backward sums and dx; ``perfbench/kernels.py``),
over the profiled epoch's supersteps."""

from perfbench import kernels


def read(run, cell):
    trace = run.trace
    if trace is None or not run.profiled:
        return None
    seconds, launches = trace.device_s(
        lambda n: kernels.family(n) == "batch_norm")
    if not launches:
        return None
    return 1e3 * seconds / run.profiled["supersteps"]
