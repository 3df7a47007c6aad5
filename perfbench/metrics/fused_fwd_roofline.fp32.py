"""The float32 fused bottleneck kernel's share of its roofline over the
profiled epoch, in % (``perfbench.roofline.fused_share``)."""

from perfbench import roofline


def read(run, cell):
    return roofline.fused_share(run, cell, "float32")
