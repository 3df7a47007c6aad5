"""The fused DenseNet bottleneck kernel's share of its roofline over the
profiled epoch, in %: the least time the card could take for each of the
epoch's calls (``perfbench.counts.fused_least_s``, from the shapes the
configuration gives: every microbatch's forward of each superstep, the
ragged tail's included, and the validation forward of the whole split)
over the device time of the kernel's launches, found by name. Nothing is
read where the kernel did not run or its launches are not the calls
counted."""

from . import counts

KERNELS = {"bfloat16": "fused_bn_relu_matmul_bf16_kernel",
           "float32": "fused_bn_relu_matmul_kernel"}


def fused_share(run, cell, dtype: str):
    trace = run.trace
    if trace is None or cell.traffic["TPU"]["compute_dtype"] != dtype:
        return None
    name = KERNELS[dtype]
    seconds, launches = trace.device_s(
        lambda n: name in n and (dtype == "bfloat16" or "bf16" not in n))
    if not launches:
        return None
    model = cell.config["model"]
    spatial = cell.config["ImageModel"]["spatial_size"]
    p = run.profiled
    calls = (p["supersteps"] * p["accum"]
             * counts.bottleneck_calls(model, spatial, p["micro_batch"])
             + counts.bottleneck_calls(model, spatial, p["val_volumes"]))
    if launches != len(calls):
        return None
    least = sum(counts.fused_least_s(m, k, n, dtype) for m, k, n in calls)
    return 100.0 * least / seconds
