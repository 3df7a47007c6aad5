"""Evaluation metrics (counterpart of the JAX package's ops/metrics.py):
Harrell's concordance index on the host and, weighted by resample counts,
on the device; per-class F1 (of thresholded sigmoid probabilities) and
confusion counts.

The pair rules are lifelines' ``concordance_index``:

* i dies at t_i, j dies at t_j > t_i: admissible;
* i dies at t_i, j is censored at t_j >= t_i: admissible;
* any other pair is not; among admissible pairs, concordant iff
  pred_i < pred_j, tied predictions count 1/2.

``C = (concordant + 0.5 * tied) / admissible``; on the host no admissible
pair raises ZeroDivisionError, as lifelines does, and on the device it
gives NaN with an admissible weight of 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CLASSIFICATION_THRESHOLD


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


def concordance_index_resamples(durations, preds, events, counts):
    """The C-index of each of R resamples given as multiplicities, on the
    tensors' device (``concordance_index_jax`` of metrics.py:66-99 for each
    row of ``counts``): a pair (i, j) weighs ``counts[r, i] *
    counts[r, j]``, so a resample drawn with replacement needs no copy of
    its samples (a sample and its duplicate never form an admissible pair).

    durations, preds, events: (N,); counts: (R, N). All in float32, as the
    JAX function casts them: a pair tied in float32 is tied here. Returns
    (R,) C-indices, NaN where a resample has no admissible pair, and (R,)
    admissible weights."""
    t = durations.reshape(-1).float()
    p = preds.reshape(-1).float()
    e = events.reshape(-1).float()
    w = counts.float()
    n = t.shape[0]
    ti, tj = t[:, None], t[None, :]
    off_diag = 1.0 - torch.eye(n, dtype=torch.float32, device=t.device)
    admissible = e[:, None] * ((ti < tj).float()
                               + (ti == tj).float() * (1.0 - e[None, :])) \
        * off_diag
    pi, pj = p[:, None], p[None, :]

    def weighted(pairs):  # sum_ij w_ri pairs_ij w_rj for each r
        return ((w @ pairs) * w).sum(-1)

    n_adm = weighted(admissible)
    c = (weighted(admissible * (pi < pj).float())
         + 0.5 * weighted(admissible * (pi == pj).float())) \
        / torch.clamp(n_adm, min=1.0)
    return torch.where(n_adm > 0, c, torch.full_like(c, float("nan"))), n_adm


def f1_scores(tps, fps, fns, num_classes: int | None = None) -> list[float]:
    """Per-class F1 from tp/fp/fn counts; a class with no positives at all
    gives 0/0 = NaN, as the reference's ``getF1Score`` does."""
    if num_classes is None:
        num_classes = len(np.asarray(tps))
    tps, fps, fns = (np.asarray(a, dtype=np.float64) for a in (tps, fps, fns))
    out = []
    for idx in range(num_classes):
        denom = tps[idx] + 0.5 * (fns[idx] + fps[idx])
        with np.errstate(invalid="ignore", divide="ignore"):
            out.append(float(tps[idx] / denom))
    return out


def thresholded_f1s(logits, labels):
    """``(probabilities, 0/1 predictions, per-class F1s)`` of (N, C) logits
    against 0/1 labels, on the host as the JAX package computes them: the
    sigmoid in numpy on the float32 logits, then ``> 0.5`` (a sigmoid on
    the card could put a probability near 0.5 on the other side)."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits)))
    pred = (probs > CLASSIFICATION_THRESHOLD).astype(np.float64)
    counts = confusion_counts(torch.from_numpy(pred),
                              torch.as_tensor(np.asarray(labels)))
    return probs, pred, f1_scores(*(c.numpy() for c in counts))


def confusion_counts(pred_labels, true_labels):
    """(tp, fp, fn) column sums of (N, C) 0/1 tensors, each (C,) int64."""
    pred, true = pred_labels.long(), true_labels.long()
    tp = ((pred == 1) & (true == 1)).sum(0)
    fp = ((pred == 1) & (true == 0)).sum(0)
    fn = ((pred == 0) & (true == 1)).sum(0)
    return tp, fp, fn
