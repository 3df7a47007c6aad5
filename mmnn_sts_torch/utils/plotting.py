"""Training-curve artifacts of the survival run (counterpart of the JAX
package's utils/plotting.py:23-57): train_val_loss.png,
train_val_c_score.png and gblend_weights_history.csv.

The CSV is written with numpy (``np.savetxt``, the JAX package's format).
matplotlib is imported inside the PNG writers: on a machine without it the
PNGs are not drawn and one warning names the missing package, while the
same curves stay in metrics.jsonl. The classification plots (F1 curves,
``LossTracker``) come with the classification path (ROADMAP.md).
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
                "matplotlib is not installed: the training-curve PNGs are "
                "not drawn (the curves are in metrics.jsonl)")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_curves(a, b, labels, path):
    plt = _pyplot()
    if plt is None:
        return
    plt.figure()
    plt.plot(a, label=labels[0])
    plt.plot(b, label=labels[1])
    plt.legend()
    plt.savefig(path)
    plt.close()


def save_loss_curves(train_losses, val_losses, out_dir="."):
    _save_curves(train_losses, val_losses, ("Train Loss", "Validation Loss"),
                 os.path.join(out_dir, "train_val_loss.png"))


def save_c_score_curves(train_cs, val_cs, out_dir="."):
    _save_curves(train_cs, val_cs, ("Train C Score", "Validation C Score"),
                 os.path.join(out_dir, "train_val_c_score.png"))


def save_blend_history(history, out_dir="."):
    np.savetxt(
        os.path.join(out_dir, "gblend_weights_history.csv"),
        np.asarray(history),
        delimiter=",",
    )
