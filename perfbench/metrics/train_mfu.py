"""The whole training run's share of the card's dense peak, in %: the
window's useful model operations (each training volume's forward and
backward, each validation volume's forward, counted from the layer shapes
by ``perfbench.counts``: no recompute, no padded row) over the window's
seconds and the peak of the traffic's ``mfu_peak`` type."""

from perfbench import counts


def read(run, cell):
    if run.window_s <= 0 or not run.train_volumes:
        return None
    flops = (run.train_volumes * counts.train_flops(cell)
             + run.val_volumes * counts.forward_flops(cell))
    peak = counts.PEAK_FLOPS[cell.traffic["mfu_peak"]]
    return 100.0 * flops / run.window_s / peak
