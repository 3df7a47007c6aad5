"""File and object-store IO for cohort tables, UID lists and artifacts
(counterpart of the JAX package's utils/store.py:23-161), without pandas.

``read_csv`` reads a CSV, local or ``s3://``, into a column table: a dict
from column name, in the file's order, to a numpy array typed as
``pandas.read_csv`` types it (int64 when every cell is an integer, float64
when every cell is a number or missing, else an object array of str with
NaN for a missing cell; pandas' default missing-value markers count as
missing).

Object stores are gated on boto3 as in the JAX package (store.py:29-34):
``open_remote``, ``fetch_to_local`` and ``list_prefix`` raise without it,
and ``upload_artifacts`` logs and returns False. A test or a run without
boto3 can stand a stub in for it (the module attributes ``boto3`` and
``HAVE_BOTO3``) that answers ``boto3.resource("s3")``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import os
import re
import tempfile

import numpy as np

from .logging import get_logger

logger = get_logger()

try:  # boto3 ships in AWS images; absent elsewhere, so every call is gated
    import boto3  # type: ignore

    HAVE_BOTO3 = True
except Exception:  # noqa: BLE001
    boto3 = None
    HAVE_BOTO3 = False

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


def _split_s3(uri: str):
    rest = uri.replace("s3://", "")
    parts = rest.split("/")
    return parts[0], "/".join(parts[1:])


@contextlib.contextmanager
def open_remote(uri: str, mode: str = "rb"):
    """Yield a local readable binary file holding an s3:// object."""
    if not uri.startswith("s3://"):
        raise ValueError(f"{uri} is not a valid S3 URI")
    if not HAVE_BOTO3:
        raise RuntimeError(
            "boto3 is not installed; cannot read S3 URIs in this environment"
        )
    bucket_name, key = _split_s3(uri)
    obj = boto3.resource("s3").Bucket(bucket_name).Object(key)
    with tempfile.NamedTemporaryFile() as tmp:
        with open(tmp.name, "rb+") as f:
            obj.download_fileobj(f)
            f.seek(0)
            yield f


def fetch_to_local(uri: str, directory: str) -> str:
    """Download a remote object to a new file under ``directory`` and
    return its path; a local path is returned as it is."""
    if not is_remote(uri):
        return uri
    if not HAVE_BOTO3:
        raise RuntimeError("boto3 unavailable for remote fetch")
    bucket_name, key = _split_s3(uri)
    fd, tmp_path = tempfile.mkstemp(suffix=os.path.splitext(key)[1],
                                    dir=directory)
    os.close(fd)
    boto3.resource("s3").Bucket(bucket_name).download_file(key, tmp_path)
    return tmp_path


def list_prefix(uri: str):
    """The object keys under an s3:// prefix."""
    if not HAVE_BOTO3:
        raise RuntimeError("boto3 unavailable for bucket listing")
    bucket_name, prefix = _split_s3(uri)
    return [o.key for o in boto3.resource("s3").Bucket(bucket_name)
            .objects.filter(Prefix=prefix)]


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
    """A CSV, local or s3://, as a column table (see the module docstring);
    with ``usecols``, only those columns, in the file's order."""
    if is_remote(path):
        with open_remote(path) as f:
            rows = list(csv.reader(io.TextIOWrapper(f, newline="")))
    else:
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
    """uid-per-line txt, local or s3://."""
    if is_remote(path):
        with open_remote(path) as f:
            return [int(line.strip()) for line in f.read().decode()
                    .splitlines() if line.strip()]
    with open(path) as f:
        return [int(line.strip()) for line in f if line.strip()]


def upload_artifacts(bucket: str, output_dir: str, filenames,
                     dest_prefix: str) -> bool:
    """Upload the files of ``output_dir`` that exist to
    ``s3://bucket/dest_prefix/``; failures are logged and swallowed, as in
    the JAX package. ``filenames``: local names, or (local name, key name)
    pairs (some artifacts are renamed on upload)."""
    if not HAVE_BOTO3:
        logger.info("Could not save to s3 bucket - no connection to S3")
        return False
    try:
        s3 = boto3.resource("s3")
        for name in filenames:
            local_name, dest_name = (
                name if isinstance(name, (tuple, list)) else (name, name))
            local = os.path.join(output_dir, local_name)
            if os.path.exists(local):
                s3.Bucket(bucket).upload_file(local,
                                              f"{dest_prefix}/{dest_name}")
        return True
    except Exception as e:  # noqa: BLE001
        logger.info("Could not save to s3 bucket - no connection to S3")
        logger.info(str(e))
        return False


def train_artifact_names(survival: bool, blend: bool):
    """The (local, key) names uploaded after training, as the JAX package
    names them: the C-index curve goes up as train_val_f1.png and the best
    survival weights as model.npz."""
    if survival:
        names = [
            ("train_val_loss.png", "train_val_loss.png"),
            ("train_val_c_score.png", "train_val_f1.png"),
            ("best_surv_model.npz", "model.npz"),
        ]
        if blend:
            names.append(
                ("gblend_weights_history.csv", "gblend_weights_history.csv"))
        return names
    return [
        ("train_val_loss.png", "train_val_loss.png"),
        ("train_val_f1.png", "train_val_f1.png"),
        ("model.npz", "model.npz"),
        ("final_model.npz", "final_model.npz"),
        ("val_loss_by_class.png", "val_loss_by_class.png"),
        ("val_loss_by_cm.png", "val_loss_by_cm.png"),
    ]
