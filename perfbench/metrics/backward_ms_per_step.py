"""Device ms a superstep of the backward pass of each microbatch: the
program's device phase stamps inside the captured step, the mean over the
window's full supersteps of the stamped ``backward`` intervals
(``perfbench.spans``)."""

from perfbench import spans


def read(run, cell):
    return spans.phase_ms_per_step(run, cell, "backward")
