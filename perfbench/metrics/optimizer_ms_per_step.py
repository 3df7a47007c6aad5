"""Device ms a superstep of the optimizer (the gradients zeroed, then the SGD
update): the program's device phase stamps inside the captured step, the
mean over the window's full supersteps of the stamped ``optimizer``
intervals (``perfbench.spans``)."""

from perfbench import spans


def read(run, cell):
    return spans.phase_ms_per_step(run, cell, "optimizer")
