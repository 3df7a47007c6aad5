"""Clinical CSV loading, cleaning and target assembly without pandas (a
counterpart of the JAX package's data/tabular.py:29-169).

The JAX package cleans the CSV with pandas; each pandas rule that decides
a value is kept here on a column table (``utils/store.read_csv``: column
name -> numpy array, in the file's order):

* only the configured columns are read, in the file's order;
* the two date columns become ``Time_MET`` = ``.dt.days`` of their
  difference (floor days, NaN where either date is missing), appended
  last, and the dates are dropped;
* ``convert_to_index``: codes in order of first appearance, as
  ``Series.unique()`` + ``map``; a missing cell is a value of its own and
  gets a code too;
* the necrosis column: NaN becomes ``"-1%"``, each value is written as
  ``str`` (``12.0`` -> ``"12.0"``), its last character is sliced off and
  ``"-1"`` becomes NaN again;
* then every column becomes float64 (``astype(float)``: a cell that is not
  a number raises ValueError);
* survival targets: a missing time is filled from ``FUtime``, an event is
  ``astype(bool)`` (NaN is True), a duration ``astype(int)`` (truncated;
  NaN raises ValueError);
* UIDs are int64, predictors and targets float32.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..utils.store import read_csv

_DATE_FORMATS = ("%m/%d/%Y", "%Y/%m/%d", "%m/%d/%y")


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and np.isnan(v)


def _parse_date(v):
    """A cell as a datetime (None where missing), for the date formats
    ``pd.to_datetime`` reads: ISO 8601 first, then month-first."""
    if _is_nan(v):
        return None
    text = str(v).strip()
    try:
        return datetime.datetime.fromisoformat(text)
    except ValueError:
        pass
    for fmt in _DATE_FORMATS:
        try:
            return datetime.datetime.strptime(text, fmt)
        except ValueError:
            pass
    raise ValueError(f"cannot parse the date {text!r}")


def _days_between(later, earlier) -> np.ndarray:
    """``(later - earlier).dt.days`` of two date columns."""
    out = []
    for a, b in zip(later, earlier):
        a, b = _parse_date(a), _parse_date(b)
        out.append(np.nan if a is None or b is None else (a - b).days)
    return np.asarray(out, dtype=np.float64)


def convert_to_index(table: dict, header: str) -> dict:
    """A categorical column -> integer codes in order of first appearance
    (a missing cell gets a code of its own, as pandas' ``unique`` + ``map``
    give it)."""
    codes: dict = {}
    nan_key = object()
    out = np.empty(len(table[header]), dtype=np.int64)
    for i, v in enumerate(table[header]):
        out[i] = codes.setdefault(nan_key if _is_nan(v) else v, len(codes))
    table[header] = out
    return table


def _pandas_str(v) -> str:
    """``astype(str)`` of one cell: numpy scalars as their Python value."""
    return str(v.item()) if isinstance(v, np.generic) else str(v)


def _as_float(name: str, col: np.ndarray) -> np.ndarray:
    if col.dtype != object:
        return col.astype(np.float64)
    out = np.empty(len(col), dtype=np.float64)
    for i, v in enumerate(col):
        try:
            out[i] = np.nan if _is_nan(v) else float(v)
        except ValueError as e:
            raise ValueError(f"column {name!r}: could not convert {v!r} to "
                             "float") from e
    return out


def load_clinical(
    filename: str,
    pre_op=None,
    post_op=None,
    targets_binary=None,
    targets_time=None,
    headers_to_convert=None,
    uid_col: str = C.UID,
) -> dict:
    """Load + clean the clinical CSV into an all-float64 column table."""
    pre_op = list(pre_op or C.PRE_OP_PREDICTORS)
    post_op = list(post_op or C.POST_OP_PREDICTORS)
    targets_binary = list(targets_binary or C.TARGETS_BINARY)
    targets_time = list(targets_time or C.TARGETS_TIME)
    headers_to_convert = list(headers_to_convert or C.HEADERS_TO_CONVERT)

    usecols = pre_op + post_op + targets_binary + targets_time + [uid_col]
    data = read_csv(filename, usecols=usecols)

    # event-date columns -> days since surgery; FUtime is already numeric
    date_cols = targets_time[1:]
    time_met = _days_between(data[date_cols[0]], data[date_cols[-1]])
    for col in date_cols:
        del data[col]
    data["Time_MET"] = time_met

    for header in headers_to_convert:
        convert_to_index(data, header)

    if C.NECROSIS_COLUMN in data:
        cells = ["-1%" if _is_nan(v) else _pandas_str(v)
                 for v in data[C.NECROSIS_COLUMN]]
        data[C.NECROSIS_COLUMN] = np.array(
            [np.nan if s[:-1] == "-1" else s[:-1] for s in cells],
            dtype=object)

    return {name: _as_float(name, col) for name, col in data.items()}


@dataclass
class ClinicalArrays:
    """Cohort-level numpy views used to build on-device batches."""

    uids: np.ndarray  # (N,) int64
    predictors: np.ndarray  # (N, F) float32
    binary_targets: np.ndarray  # (N, C) float32
    events: np.ndarray  # (N, C) float32 (0/1)
    durations: np.ndarray  # (N, C) float32 (integer-valued days)
    predictor_names: list[str]
    raw: dict  # cleaned column table, kept for stratification features


def _surv_targets(data: dict, header_pairs) -> tuple[np.ndarray, np.ndarray]:
    events, durations = [], []
    for event_col, time_col in header_pairs:
        t = data[time_col]
        if time_col != "FUtime":
            t = np.where(np.isnan(t), data["FUtime"], t)
        if not np.isfinite(t).all():
            raise ValueError(
                f"Cannot convert non-finite values (NA or inf) to integer: "
                f"{time_col!r} has missing times that FUtime does not fill")
        events.append(data[event_col] != 0)  # NaN != 0: NaN is an event
        durations.append(t.astype(np.int64))
    return (
        np.stack(events, axis=1).astype(np.float32),
        np.stack(durations, axis=1).astype(np.float32),
    )


def _matrix(data: dict, names, dtype) -> np.ndarray:
    n = len(next(iter(data.values())))
    if not names:
        return np.zeros((n, 0), dtype=dtype)
    return np.stack([data[name] for name in names], axis=1).astype(dtype)


def load_clinical_arrays(
    filename: str,
    preop: bool = True,
    postop: bool = False,
    clinical_cfg=None,
    header_pairs=None,
    uid_col: str = C.UID,
) -> ClinicalArrays:
    """Eagerly build the cohort's predictor/target arrays: preop selects
    the pre-operative predictors, postop alone the post-operative ones,
    both their concatenation."""
    if clinical_cfg is not None:
        pre_op = clinical_cfg.pre_op_predictors
        post_op = clinical_cfg.post_op_predictors
        targets_binary = clinical_cfg.targets_binary
        targets_time = clinical_cfg.targets_time
        headers = clinical_cfg.headers_to_convert
    else:
        pre_op, post_op = C.PRE_OP_PREDICTORS, C.POST_OP_PREDICTORS
        targets_binary, targets_time = C.TARGETS_BINARY, C.TARGETS_TIME
        headers = C.HEADERS_TO_CONVERT
    header_pairs = header_pairs or C.HEADER_PAIRS

    data = load_clinical(
        filename, pre_op, post_op, targets_binary, targets_time, headers, uid_col
    )
    predictor_names = list(post_op if (postop and not preop) else pre_op)
    if preop and postop:
        predictor_names = list(pre_op) + list(post_op)

    events, durations = _surv_targets(data, header_pairs)
    return ClinicalArrays(
        uids=data[uid_col].astype(np.int64),
        predictors=_matrix(data, predictor_names, np.float32),
        binary_targets=_matrix(data, list(targets_binary), np.float32),
        events=events,
        durations=durations,
        predictor_names=predictor_names,
        raw=data,
    )


def add_cutoffs(data: dict) -> dict:
    """The tumour-volume cutoff stratification feature (0: < 500 cm^3 or
    missing, 1: 500-1000, 2: > 1000), appended as ``VolumeCutoff``."""
    vol = data[C.TUMOR_VOLUME_COLUMN]
    cutoff = np.zeros(len(vol), dtype=np.int64)
    cutoff[vol >= 500] = 1
    cutoff[vol > 1000] = 2
    return {**data, "VolumeCutoff": cutoff}
