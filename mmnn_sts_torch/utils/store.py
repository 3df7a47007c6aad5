"""Local file IO for cohort tables and UID lists (counterpart of the JAX
package's utils/store.py:38-98), without pandas.

``read_csv`` reads a CSV into a column table: a dict from column name, in
the file's order, to a numpy array typed as ``pandas.read_csv`` types it
(int64 when every cell is an integer, float64 when every cell is a number
or missing, else an object array of str with NaN for a missing cell;
pandas' default missing-value markers count as missing). Object-store paths (``s3://``, ``gs://``) raise as the JAX
package does without boto3 (store.py:55-58); the upload of artifacts is
not ported (ROADMAP.md).
"""

from __future__ import annotations

import csv
import re

import numpy as np

# pandas.read_csv's default na_values
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT = re.compile(
    r"^\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
    r"|[iI][nN][fF]([iI][nN][iI][tT][yY])?)\s*$")


def is_remote(path: str) -> bool:
    return isinstance(path, str) and (
        path.startswith("s3://") or path.startswith("gs://")
    )


def _refuse_remote(path: str):
    if is_remote(path):
        raise RuntimeError(
            f"{path}: boto3 is not installed; cannot read S3 URIs in this "
            "environment (object stores are not ported to mmnn_sts_torch, "
            "see ROADMAP.md)"
        )


def _typed_column(cells: list) -> np.ndarray:
    """One column's cells (str) typed as pandas.read_csv types them."""
    missing = [c in _NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    if not any(missing) and all(_INT.match(c) for c in present):
        return np.array([int(c) for c in cells], dtype=np.int64)
    if all(_FLOAT.match(c) for c in present):
        return np.array([np.nan if m else float(c)
                         for c, m in zip(cells, missing)], dtype=np.float64)
    return np.array([np.nan if m else c for c, m in zip(cells, missing)],
                    dtype=object)


def read_csv(path: str, usecols=None) -> dict[str, np.ndarray]:
    """A local CSV as a column table (see the module docstring); with
    ``usecols``, only those columns, in the file's order."""
    _refuse_remote(path)
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], [r for r in rows[1:] if r]
    keep = set(header if usecols is None else usecols)
    table = {}
    for j, name in enumerate(header):
        if name in keep:
            table[name] = _typed_column(
                [r[j] if j < len(r) else "" for r in body])
    return table


def load_uids_any(path: str):
    """uid-per-line txt (local)."""
    _refuse_remote(path)
    with open(path) as f:
        return [int(line.strip()) for line in f if line.strip()]
