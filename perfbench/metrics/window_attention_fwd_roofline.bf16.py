"""The bfloat16 windowed attention's forward kernel's share of its
roofline over the profiled epoch, in %: the least time the card could take
for each of the epoch's forward calls (``perfbench.attention.least_s``,
from the configuration's sizes: every microbatch of each superstep, the
ragged tail's included, and the validation forward of the whole split)
over the device time of the forward kernel's launches, found by name.
Nothing is read where the kernel did not run, the cell computes in
another type, or its launches are not the calls counted."""

from perfbench import attention


def read(run, cell):
    trace = run.trace
    if trace is None or not run.profiled:
        return None
    if cell.traffic["TPU"]["compute_dtype"] != "bfloat16":
        return None
    model = cell.config["model"]
    if "window_size" not in model:
        return None
    seconds, launches = trace.device_s(
        lambda n: attention.FORWARD.search(n) is not None)
    if not launches:
        return None
    spatial = cell.config["ImageModel"]["spatial_size"]
    p = run.profiled
    calls = (p["supersteps"] * p["accum"]
             * attention.forward_calls(model, spatial, p["micro_batch"])
             + attention.forward_calls(model, spatial, p["val_volumes"]))
    if launches != len(calls):
        return None
    least = sum(attention.least_s(c, "bfloat16") for c in calls)
    return 100.0 * least / seconds
