"""Training-curve artifacts (counterpart of the JAX package's
utils/plotting.py): train_val_loss.png, train_val_c_score.png (survival),
train_val_f1.png and the ``LossTracker``'s val_loss_by_cm.png and
val_loss_by_class.png (classification), gblend_weights_history.csv, and
the LR range test's lr_finder.png (train/lr_finder.py:108-114).

The CSV is written with numpy (``np.savetxt``, the JAX package's format).
matplotlib is imported inside the PNG writers: on a machine without it the
PNGs are not drawn and one warning names the missing package, while the
training curves stay in metrics.jsonl.
"""

from __future__ import annotations

import os

import numpy as np

from .logging import get_logger

_warned = []


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (warned once)."""
    try:
        import matplotlib
    except ImportError:
        if not _warned:
            _warned.append(True)
            get_logger().warning(
                "matplotlib is not installed: the PNG curves are not drawn "
                "(the training curves are in metrics.jsonl)")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_curves(curves, labels, path):
    plt = _pyplot()
    if plt is None:
        return
    plt.figure()
    for curve, label in zip(curves, labels):
        plt.plot(curve, label=label)
    plt.legend()
    plt.savefig(path)
    plt.close()


def save_loss_curves(train_losses, val_losses, out_dir="."):
    _save_curves((train_losses, val_losses), ("Train Loss", "Validation Loss"),
                 os.path.join(out_dir, "train_val_loss.png"))


def save_c_score_curves(train_cs, val_cs, out_dir="."):
    _save_curves((train_cs, val_cs), ("Train C Score", "Validation C Score"),
                 os.path.join(out_dir, "train_val_c_score.png"))


def save_f1_curves(train_f1s, val_f1s, out_dir="."):
    _save_curves((train_f1s, val_f1s),
                 ("Train F1 Score", "Validation F1 Score"),
                 os.path.join(out_dir, "train_val_f1.png"))


def save_lr_finder_curve(lrs, losses, out_dir="."):
    """lr_finder.png: the smoothed loss against the learning rate, the
    rate's axis logarithmic."""
    plt = _pyplot()
    if plt is None:
        return
    plt.figure()
    plt.plot(lrs, losses)
    plt.xscale("log")
    plt.xlabel("learning rate")
    plt.ylabel("smoothed loss")
    plt.savefig(os.path.join(out_dir, "lr_finder.png"))
    plt.close()


def save_blend_history(history, out_dir="."):
    np.savetxt(
        os.path.join(out_dir, "gblend_weights_history.csv"),
        np.asarray(history),
        delimiter=",",
    )


class LossTracker:
    """Confusion-quadrant loss diagnostics of the validation epochs
    (plotting.py:58-103): the mean unreduced loss of the TP, FP, FN and TN
    entries, of all, and of each class (VS, DM)."""

    CURVES = ("tp_loss", "fp_loss", "fn_loss", "tn_loss", "total_loss",
              "vs_loss", "dm_loss")

    def __init__(self, curves: dict | None = None):
        """``curves``: the lists of an earlier run's ``curves()`` to carry
        on (a resumed run)."""
        for name in self.CURVES:
            setattr(self, name, (curves or {}).get(name, []))

    def curves(self) -> dict:
        """The curves so far, by name (the lists themselves)."""
        return {name: getattr(self, name) for name in self.CURVES}

    def update(self, preds, labels, loss):
        """preds, labels: (N, C) 0/1; loss: (N, C) unreduced."""
        preds, labels, loss = (np.asarray(a) for a in (preds, labels, loss))

        def mean_where(mask):
            return float(loss[mask].mean()) if mask.any() else float("nan")

        self.tp_loss.append(mean_where((preds == 1) & (labels == 1)))
        self.fp_loss.append(mean_where((preds == 1) & (labels == 0)))
        self.fn_loss.append(mean_where((preds == 0) & (labels == 1)))
        self.tn_loss.append(mean_where((preds == 0) & (labels == 0)))
        self.total_loss.append(float(loss.mean()))
        self.vs_loss.append(float(loss[:, 0].mean()))
        self.dm_loss.append(float(loss[:, 1].mean()))

    def save_plots(self, out_dir="."):
        _save_curves(
            (self.tp_loss, self.fp_loss, self.fn_loss, self.tn_loss,
             self.total_loss),
            ("tp loss", "fp loss", "fn loss", "tn loss", "all loss (mean)"),
            os.path.join(out_dir, "val_loss_by_cm.png"))
        _save_curves((self.vs_loss, self.dm_loss, self.total_loss),
                     ("VS loss", "DM loss", "All loss (mean)"),
                     os.path.join(out_dir, "val_loss_by_class.png"))
