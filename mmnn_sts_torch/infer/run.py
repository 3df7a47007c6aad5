"""Inference on the test split: C-indices or F1s, the bootstrap confidence
intervals, the Grad-CAM attention maps and the prediction CSVs
(counterpart of the JAX package's infer/run.py:54-272).

* ``inference_survival``: one forward over the split (head 0 under
  blending), then the host C-indices and survival_model_predictions.csv;
  with ``bootstrap``, 50 resamples with replacement instead,
  each a vector of multiplicities drawn as sklearn's ``resample`` draws
  (``RandomState(seed).randint(0, n, size=n)`` per resample, one stream),
  and their C-indices computed together on the split's device
  (``ops/metrics.concordance_index_resamples``). A resample in which a
  class has no admissible pair is dropped; the mean and the population
  standard deviation (ddof 0) of the rest are reported.
* ``inference_classification``: probabilities as ``1 / (1 + exp(-logit))``
  in numpy on the float32 logits, ``> 0.5``, per-class F1s and
  model_probabilities.csv.
* ``export_attention_maps``: one directory per patient under
  ``attention_maps/``: ``_patient_{uid}`` for survival (with that patient's
  own forward in preds.txt), ``{correct}_{labels}_{preds}__patient_{uid}``
  for classification (with its probabilities).

A host-resident test split (``TPU.device_resident_dataset: false``) is
forwarded in chunks, each copied to the card alone (``train/evaluate``),
and Grad-CAM copies one patient at a time.

Under a mesh of ranks (``state.mesh``) the forward is sharded over the
``data`` axis and its predictions gathered (``train/steps.py``), so every
rank computes the same C-indices or F1s; rank 0 alone draws the Grad-CAM
maps (a batch of one) and writes the files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import NUM_BOOTSTRAP_ITERATIONS
from ..data.loader import DeviceDataset
from ..data.nifti import save_attention_maps
from ..data.streaming import HostDataset, to_device
from ..ops.augment import eval_transform_batch
from ..ops.gradcam import attention_maps
from ..ops.metrics import (
    c_indices_per_class,
    concordance_index_resamples,
    thresholded_f1s,
)
from ..parallel.mesh import is_writer
from ..train.evaluate import classification_eval_split, survival_eval_split
from ..utils.logging import get_logger
from ..utils.store import upload_artifacts
from .artifacts import save_probabilities_csv, save_survival_predictions_csv

logger = get_logger()


@dataclass
class InferenceConfig:
    blend: bool = False
    bootstrap: bool = False
    gradcam: bool = True
    output_dir: str = "."
    seed: int = 42
    # write the prediction CSV (survival_model_predictions.csv or
    # model_probabilities.csv)
    save_preds: bool = True
    # forward chunk size; 0 = the whole split at once
    eval_chunk: int = 0
    # the survival CSV's upload to s3://bucket/dest_prefix/ after it is
    # written; an empty bucket uploads nothing
    bucket: str = ""
    dest_prefix: str = "models"
    # Cox tie handling of the forward's loss ("breslow" | "efron")
    ties: str = "breslow"


def bootstrap_counts(n: int, num: int, seed: int) -> np.ndarray:
    """(num, n) float32 multiplicities of ``num`` resamples of n samples
    with replacement, drawn as sklearn's ``resample`` draws its indices."""
    rng = np.random.RandomState(seed)
    counts = np.zeros((num, n), dtype=np.float32)
    for r in range(num):
        np.add.at(counts[r], rng.randint(0, n, size=n), 1.0)
    return counts


def bootstrap_cindices(preds, events, durations, counts):
    """(R, C) C-indices and admissible weights of the resamples ``counts``
    (R, N), one class at a time on the tensors' device; preds, events and
    durations (N, C)."""
    cs, adms = zip(*(concordance_index_resamples(
        durations[:, c], preds[:, c], events[:, c], counts)
        for c in range(preds.shape[1])))
    return torch.stack(cs, 1), torch.stack(adms, 1)


def _head0(preds, blend: bool):
    return preds[0] if blend else preds


def inference_survival(state, ds: DeviceDataset, cfg: InferenceConfig):
    """Survival inference over a test split (run.py:103-161)."""
    preds = _head0(survival_eval_split(state, ds, blend=cfg.blend,
                                       ties=cfg.ties, chunk=cfg.eval_chunk)
                   ["preds"], cfg.blend)
    events = ds.events.cpu().numpy()
    durations = ds.durations.cpu().numpy()

    if cfg.gradcam and is_writer(state.mesh):
        export_attention_maps(state, ds, cfg, survival=True)

    if cfg.bootstrap:
        counts = bootstrap_counts(ds.num_samples, NUM_BOOTSTRAP_ITERATIONS,
                                  cfg.seed)
        cs, adms = bootstrap_cindices(
            torch.as_tensor(preds).to(ds.device), ds.events.to(ds.device),
            ds.durations.to(ds.device),
            torch.as_tensor(counts).to(ds.device))
        cs, adms = cs.cpu().numpy(), adms.cpu().numpy()
        cs = cs[(adms > 0).all(axis=1)]  # a degenerate class voids it
        means, stds = cs.mean(axis=0), cs.std(axis=0)
        logger.info(f"Mean c indices: {means}")
        logger.info(f"Std. devs: {stds}")
        return {"mean_c": means, "std_c": stds, "resample_c": cs}

    c_indices = c_indices_per_class(preds, events, durations)
    logger.info(f"Inference complete - C-Indices: {c_indices}")
    logger.info(f"Mean C-Index: {np.mean(c_indices)}")
    if cfg.save_preds and is_writer(state.mesh):
        save_survival_predictions_csv(
            os.path.join(cfg.output_dir, "survival_model_predictions.csv"),
            ds.uids, preds, events, durations)
        if cfg.bucket:
            upload_artifacts(cfg.bucket, cfg.output_dir,
                             ["survival_model_predictions.csv"],
                             cfg.dest_prefix)
    return {"c_indices": c_indices, "preds": preds}


def inference_classification(state, ds: DeviceDataset,
                             cfg: InferenceConfig):
    """Classification inference over a test split (run.py:164-200)."""
    labels = ds.labels.cpu().numpy()
    logits = classification_eval_split(
        state, ds, torch.ones(labels.shape[-1]), blend=cfg.blend,
        chunk=cfg.eval_chunk)["preds"]
    probs, pred_lbl, f1s = thresholded_f1s(_head0(logits, cfg.blend), labels)

    if cfg.gradcam and is_writer(state.mesh):
        export_attention_maps(state, ds, cfg, survival=False,
                              pred_labels=pred_lbl, labels=labels,
                              probs=probs)

    logger.info(f"{f1s}")
    logger.info(f"{np.nanmean(f1s)}")
    if cfg.save_preds and is_writer(state.mesh):
        save_probabilities_csv(
            os.path.join(cfg.output_dir, "model_probabilities.csv"), ds.uids,
            probs, labels)
    return {"f1s": f1s, "probs": probs}


def export_attention_maps(state, ds: DeviceDataset, cfg: InferenceConfig,
                          survival: bool, pred_labels=None, labels=None,
                          probs=None):
    """Per-patient Grad-CAM NIfTI export (run.py:203-266). The exported
    att_map is class 0's (VitalStatus); the others are att_map_cls{c}."""
    att_dir = os.path.join(cfg.output_dir, "attention_maps")
    os.makedirs(att_dir, exist_ok=True)
    model = state.model.eval()
    targets = ds.events if survival else ds.labels
    num_classes = int(targets.shape[-1])

    for i, uid in enumerate(ds.uids):
        inputs = ds.model_inputs(idx=slice(i, i + 1))
        if isinstance(ds, HostDataset):
            inputs = to_device(ds, {"inputs": inputs})["inputs"]
        if isinstance(inputs, dict):
            inputs = {**inputs, "image": eval_transform_batch(inputs["image"])}
            image = inputs["image"]
        else:
            inputs = image = eval_transform_batch(inputs)
        maps = attention_maps(model, inputs, num_classes,
                              blend=cfg.blend).cpu().numpy()
        image = image.cpu().numpy()
        t1 = image[0, ..., 0]
        t2 = image[0, ..., 1] if image.shape[-1] > 1 else image[0, ..., 0]

        if survival:
            dirname = f"_patient_{uid}"
            with torch.no_grad():
                preds_out = _head0(model(inputs), cfg.blend)[0]
            preds_out = preds_out.float().cpu().numpy()
            preds_filename = "preds.txt"
        else:
            correct = "".join(
                "1" if pred_labels[i, c] == labels[i, c] else "0"
                for c in range(labels.shape[1]))
            lbl = "".join(str(int(x)) for x in labels[i])
            prd = "".join(str(int(x)) for x in pred_labels[i])
            dirname = f"{correct}_{lbl}_{prd}__patient_{uid}"
            preds_out = probs[i]
            preds_filename = "probabilities.txt"

        save_attention_maps(
            os.path.join(att_dir, dirname), t1, t2, maps[0], preds_out,
            preds_filename=preds_filename,
            extra_maps={c: maps[c] for c in range(1, maps.shape[0])})
