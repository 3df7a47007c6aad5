"""Prediction CSVs of the inference run (counterpart of the JAX package's
infer/artifacts.py), written with plain file writes, byte for byte as the
JAX package's ``pandas.DataFrame.to_csv(path, index=False)`` writes them:

* survival_model_predictions.csv: MRN, VS_pred, DM_pred, VS_event,
  DM_event, VS_duration, DM_duration;
* model_probabilities.csv: a header ``0,1,...`` of column numbers, then the
  uid, the per-class probabilities and the labels.

The columns are one float64 array, as the JAX package concatenates them,
so a uid is written as ``12.0``. pandas writes a float64 as Python's
shortest round-trip ``repr``, a NaN as an empty field, and ends each line
with ``\\n``.
"""

from __future__ import annotations

import numpy as np


def _field(value: float) -> str:
    return "" if np.isnan(value) else repr(float(value))


def _write_csv(path: str, header, data: np.ndarray):
    with open(path, "w", newline="") as f:
        f.write(",".join(str(h) for h in header) + "\n")
        for row in data:
            f.write(",".join(_field(v) for v in row) + "\n")


def save_survival_predictions_csv(path, uids, preds, events, durations,
                                  cls_names=None):
    preds = np.asarray(preds)
    cls_names = cls_names or ["VS", "DM"][: preds.shape[1]]
    data = np.concatenate(
        [np.asarray(uids).reshape(-1, 1).astype(float), preds,
         np.asarray(events), np.asarray(durations)], axis=1)
    header = (["MRN"] + [c + "_pred" for c in cls_names]
              + [c + "_event" for c in cls_names]
              + [c + "_duration" for c in cls_names])
    _write_csv(path, header, data)


def save_probabilities_csv(path, uids, probs, labels):
    data = np.concatenate(
        [np.asarray(uids).reshape(-1, 1).astype(int), np.asarray(probs),
         np.asarray(labels)], axis=1)
    _write_csv(path, range(data.shape[1]), data)
