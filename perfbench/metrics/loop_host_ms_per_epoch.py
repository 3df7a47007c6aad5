"""Host ms an epoch of the loop's own work while the card has nothing
queued: the program's ``loop.epoch`` span less its ``loop.dispatch`` and
``loop.readback`` children, the mean over the window's epochs
(``perfbench.spans``)."""

from perfbench import spans


def read(run, cell):
    return spans.loop_host_ms_per_epoch(run, cell)
