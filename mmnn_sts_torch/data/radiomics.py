"""Radiomics feature tables without pandas (counterpart of the JAX
package's data/radiomics.py:22-42): a PyRadiomics CSV minus its
diagnostic and label columns is the predictor matrix, joined to the
clinical labels on the UID column."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..utils.store import read_csv
from .tabular import _as_float


@dataclass
class RadiomicsArrays:
    uids: np.ndarray  # (N,)
    features: np.ndarray  # (N, F) float32
    feature_names: list


def load_radiomics(radiomics_csv: str, exclude_columns=None, uid_col=C.UID):
    exclude = set(exclude_columns or C.RADIOMICS_EXCLUDE_COLUMNS)
    exclude |= set(C.RADIOMICS_LABEL_COLUMNS)
    table = read_csv(radiomics_csv)
    uids = table[uid_col].astype(np.int64)
    names = [c for c in table if c not in exclude and c != uid_col]
    feats = [_as_float(c, table[c]) for c in names]
    return RadiomicsArrays(
        uids=uids,
        features=(np.stack(feats, axis=1) if feats
                  else np.zeros((len(uids), 0))).astype(np.float32),
        feature_names=names,
    )
