"""Device ms a superstep of the windowed attention's SDPA kernels, forward
and backward (``perfbench.attention.KERNELS``: the memory-efficient
backend's ``fmha_cutlass*`` launches of ``ops/window_attention``), over
the profiled epoch's supersteps, the validation forward's share included.
Nothing is read where no such kernel ran."""

from perfbench import attention


def read(run, cell):
    trace = run.trace
    if trace is None or not run.profiled:
        return None
    seconds, launches = trace.device_s(
        lambda n: attention.KERNELS.search(n) is not None)
    if not launches:
        return None
    return 1e3 * seconds / run.profiled["supersteps"]
