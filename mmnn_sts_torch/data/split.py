"""Stratified 70/15/15 cohort split by iterative multilabel stratification
(a copy of the JAX package's data/split.py:29-166, on the port's column
table instead of a DataFrame, so the UID lists are the same).

The split stratifies on the STRATIFY_BY categorical columns (with the
tumour-volume cutoff added) plus the binary targets: 70/30, then 50/50 of
the holdout, and writes the train/val/test UID lists to txt files.
Iterative stratification: Sechidis, Tsoumakas & Vlahavas, ECML PKDD 2011;
every tie is broken deterministically under the seed.
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants as C
from .tabular import add_cutoffs


def _binarize_labels(matrix: np.ndarray) -> np.ndarray:
    """Expand categorical label columns into one-hot indicator columns."""
    cols = []
    for j in range(matrix.shape[1]):
        col = matrix[:, j]
        for v in np.unique(col):
            cols.append((col == v).astype(np.int8))
    if not cols:
        return np.zeros((matrix.shape[0], 0), dtype=np.int8)
    return np.stack(cols, axis=1)


def iterative_stratified_split(
    labels: np.ndarray, test_fraction: float, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Two-fold iterative stratification of an (N, L) 0/1 indicator
    matrix; returns (train_indices, test_indices), sorted."""
    rng = np.random.default_rng(seed)
    n, n_labels = labels.shape
    fractions = np.array([1.0 - test_fraction, test_fraction])

    desired_total = fractions * n
    desired_per_label = fractions[None, :] * labels.sum(axis=0)[:, None]  # (L, 2)

    fold_of = np.full(n, -1, dtype=np.int64)
    remaining = np.ones(n, dtype=bool)

    while remaining.any():
        # Pick the label with the fewest remaining examples (but > 0).
        remaining_per_label = labels[remaining].sum(axis=0)
        candidates = np.where(remaining_per_label > 0)[0]
        if len(candidates) == 0:
            # No labels left: place leftover examples by total-count deficit.
            for i in np.where(remaining)[0]:
                deficit = desired_total - np.bincount(
                    fold_of[fold_of >= 0], minlength=2
                )
                order = np.argsort(-(deficit + rng.uniform(0, 1e-6, size=2)))
                fold_of[i] = order[0]
                remaining[i] = False
            break
        lbl = candidates[np.argmin(remaining_per_label[candidates])]

        examples = np.where(remaining & (labels[:, lbl] == 1))[0]
        # Deterministic shuffle so assignment order doesn't follow file order.
        examples = examples[rng.permutation(len(examples))]
        for i in examples:
            placed = np.bincount(fold_of[fold_of >= 0], minlength=2).astype(float)
            placed_lbl = np.array(
                [
                    labels[(fold_of == f), lbl].sum() if (fold_of == f).any() else 0
                    for f in range(2)
                ],
                dtype=float,
            )
            label_deficit = desired_per_label[lbl] - placed_lbl
            best = np.where(label_deficit == label_deficit.max())[0]
            if len(best) > 1:
                total_deficit = (desired_total - placed)[best]
                best = best[total_deficit == total_deficit.max()]
                if len(best) > 1:
                    best = best[[rng.integers(len(best))]]
            fold_of[i] = best[0]
            remaining[i] = False

    train_idx = np.sort(np.where(fold_of == 0)[0])
    test_idx = np.sort(np.where(fold_of == 1)[0])
    return train_idx, test_idx


def stratified_split(
    raw_table: dict,
    uids,
    seed: int = 42,
    stratify_by=None,
    targets_binary=None,
    uid_col: str = C.UID,
    write_files: bool = True,
    output_dir: str = ".",
):
    """70/15/15 stratified split of the cohort rows of ``raw_table`` (the
    cleaned clinical column table) whose UID is in ``uids``, in the table's
    row order; writes {train,val,test}_uids.txt into ``output_dir``.
    Returns (train_uids, val_uids, test_uids) as python int lists."""
    stratify_by = list(stratify_by or C.STRATIFY_BY)
    targets_binary = list(targets_binary or C.TARGETS_BINARY)

    keep = np.isin(raw_table[uid_col], [int(u) for u in uids])
    frame = add_cutoffs({k: v[keep] for k, v in raw_table.items()})

    label_source = np.stack(
        [np.asarray(frame[c], dtype=float) for c in stratify_by + targets_binary],
        axis=1,
    )
    labels = _binarize_labels(label_source)
    uid_arr = frame[uid_col].astype(np.int64)

    train_i, holdout_i = iterative_stratified_split(labels, 0.3, seed)
    hold_labels = labels[holdout_i]
    val_rel, test_rel = iterative_stratified_split(hold_labels, 0.5, seed + 1)
    val_i, test_i = holdout_i[val_rel], holdout_i[test_rel]

    train_uids = [int(u) for u in uid_arr[train_i]]
    val_uids = [int(u) for u in uid_arr[val_i]]
    test_uids = [int(u) for u in uid_arr[test_i]]

    if write_files:
        for name, lst in [
            ("train_uids.txt", train_uids),
            ("val_uids.txt", val_uids),
            ("test_uids.txt", test_uids),
        ]:
            with open(os.path.join(output_dir, name), "w") as f:
                f.write("\n".join(str(u) for u in lst))

    return train_uids, val_uids, test_uids
