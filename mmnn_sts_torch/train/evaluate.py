"""Full-split evaluation with optional fixed-size chunks (counterpart of
the JAX package's train/evaluate.py).

The split is forwarded in chunks (or whole), the per-chunk losses are
summed (the sum-over-batches semantics of both the Cox loss and the
selection loss) and the predictions are concatenated on the host, as
float32 (the float32 values of bfloat16 logits).

Chunking (``resolve_chunk``, evaluate.py:27-38): an explicit size wins;
otherwise a device-resident split goes whole and a host-resident one
(``data/streaming.HostDataset``) in chunks of ``DEFAULT_EVAL_CHUNK``, each
copied to the card alone.
"""

from __future__ import annotations

import numpy as np

from ..data.streaming import HostDataset, to_device
from .steps import classification_eval_step, survival_eval_step

DEFAULT_EVAL_CHUNK = 64


def resolve_chunk(ds, chunk: int = 0) -> int:
    """Effective chunk size for a split: 0 means the whole split at once."""
    if chunk:
        return int(chunk)
    return DEFAULT_EVAL_CHUNK if isinstance(ds, HostDataset) else 0


def _chunk_slices(n: int, chunk: int):
    for start in range(0, n, chunk):
        yield slice(start, min(start + chunk, n))


def _split_chunks(ds, chunk: int, names):
    """The split in chunks on its device: ``{"inputs", *names}`` a chunk
    (``chunk`` as ``resolve_chunk`` reads it)."""
    chunk = resolve_chunk(ds, chunk)
    n = ds.num_samples
    slices = [slice(0, n)] if not chunk or chunk >= n else list(
        _chunk_slices(n, chunk))
    for sl in slices:
        batch = {"inputs": ds.model_inputs(sl)}
        batch.update({name: getattr(ds, name)[sl] for name in names})
        yield to_device(ds, batch) if isinstance(ds, HostDataset) else batch


def survival_eval_split(state, ds, blend: bool, ties: str, chunk: int = 0):
    """Forward a whole split: {"preds": ([K,] N, C) numpy, "loss": float,
    "selection_loss": float}, the losses summed over samples (the caller
    divides by N)."""
    preds, loss, sel = [], 0.0, 0.0
    for batch in _split_chunks(ds, chunk, ("events", "durations")):
        out = survival_eval_step(state, batch["inputs"], batch["events"],
                                 batch["durations"], blend=blend, ties=ties)
        preds.append(out["preds"].float().cpu().numpy())
        loss += out["loss"].item()
        sel += out["selection_loss"].item()
    return {
        "preds": np.concatenate(preds, axis=1 if blend else 0),
        "loss": loss,
        "selection_loss": sel,
    }


def classification_eval_split(state, ds, pos_weight, blend: bool,
                              chunk: int = 0):
    """Forward a whole classification split: {"preds": ([K,] N, C) numpy,
    "elementwise": (N, C) numpy, "loss": float}, the loss summed over
    samples (evaluate.py:91-124)."""
    preds, elementwise, loss = [], [], 0.0
    for batch in _split_chunks(ds, chunk, ("labels",)):
        out = classification_eval_step(state, batch["inputs"],
                                       batch["labels"], pos_weight,
                                       blend=blend)
        preds.append(out["preds"].float().cpu().numpy())
        elementwise.append(out["elementwise"].cpu().numpy())
        loss += out["loss"].item()
    return {
        "preds": np.concatenate(preds, axis=1 if blend else 0),
        "elementwise": np.concatenate(elementwise, axis=0),
        "loss": loss,
    }
