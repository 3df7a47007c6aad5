"""Harrell's concordance index on the host (a copy of the numpy half of the
JAX package's ops/metrics.py, metrics.py:35-63 and 102-116).

The pair rules are lifelines' ``concordance_index``:

* i dies at t_i, j dies at t_j > t_i: admissible;
* i dies at t_i, j is censored at t_j >= t_i: admissible;
* any other pair is not; among admissible pairs, concordant iff
  pred_i < pred_j, tied predictions count 1/2.

``C = (concordant + 0.5 * tied) / admissible``; no admissible pair raises
ZeroDivisionError, as lifelines does.
"""

from __future__ import annotations

import numpy as np


def _pair_stats(durations, preds, events):
    t = np.asarray(durations, dtype=np.float64).reshape(-1)
    p = np.asarray(preds, dtype=np.float64).reshape(-1)
    e = np.asarray(events).reshape(-1).astype(bool)
    ti, tj = t[:, None], t[None, :]
    # i is the earlier death of each ordered pair (i, j)
    admissible = e[:, None] & ((ti < tj) | ((ti == tj) & ~e[None, :]))
    np.fill_diagonal(admissible, False)
    pi, pj = p[:, None], p[None, :]
    return ((admissible & (pi < pj)).sum(), (admissible & (pi == pj)).sum(),
            admissible.sum())


def concordance_index(durations, preds, events) -> float:
    """Harrell C-index with lifelines' argument order (event times,
    predicted scores, event observed)."""
    concordant, tied, admissible = _pair_stats(durations, preds, events)
    if admissible == 0:
        raise ZeroDivisionError("No admissible pairs in the dataset.")
    return float((concordant + 0.5 * tied) / admissible)


def c_indices_per_class(preds, events, durations) -> list[float]:
    """One C-index per target column of (N, C) arrays."""
    preds, events, durations = (np.asarray(a) for a in
                                (preds, events, durations))
    return [concordance_index(durations[:, i], preds[:, i], events[:, i])
            for i in range(preds.shape[1])]
