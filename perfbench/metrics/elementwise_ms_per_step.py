"""Device ms a superstep of PyTorch's elementwise and reduction kernels
(train-mode BatchNorm, ReLU, dropout, the casts, the augmentation's
pointwise work; ``perfbench/kernels.py``), over the profiled epoch's
supersteps."""

from perfbench import kernels


def read(run, cell):
    trace = run.trace
    if trace is None or not run.profiled:
        return None
    seconds, launches = trace.device_s(
        lambda n: kernels.family(n) == "elementwise")
    if not launches:
        return None
    return 1e3 * seconds / run.profiled["supersteps"]
