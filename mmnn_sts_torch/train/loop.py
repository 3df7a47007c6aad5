"""The training loops (counterpart of the JAX package's train/loop.py, its
per-step paths): ``train_survival`` (loop.py:54-402) and
``train_classification`` (loop.py:405-656).

Survival, per epoch: the shuffled, wrap-padded superstep indices
(``EpochBatcher``), one ``survival_train_superstep`` per super-batch
gathered on the device
(the ragged last one with its pad mask), one read-back of the epoch's
losses and predictions; the train C-index over the first N rows of the
prediction stream (the shuffled order; the wrap pad is left out);
validation loss and C-indices; best-model selection on the multimodal
head's unweighted loss, with the best weights written in the background
(``AsyncNpzSaver``); the gradient-blend update every
``blend_update_interval`` epochs from the train predictions (in shuffled
order, with their events and durations in the same order) and the
epoch's validation predictions; then the loss and C-index curves and the
blend history.

Classification, per epoch: one ``classification_train_step`` per shuffled
batch of ``batch_size`` (the ragged last one masked), BCE-with-logits with
``pos_weight`` from the train split's label frequencies, one read-back;
the train F1 over the first N rows of the logit stream; validation loss,
F1s and the ``LossTracker``; best-model selection on the mean validation
F1 (strictly greater; a NaN never wins); the blend update on the raw
logits (the classification sign convention); then the loss and F1 curves,
the tracker's plots, the blend history and ``final_<name>``.

With a ``checkpoint_dir`` every epoch is checkpointed (the full state, see
``train/checkpoint.py``), and a state restored from one resumes at its
epoch: the loop runs epochs ``state.epoch`` to ``epochs - 1``, so an
interrupted run resumed with the same settings ends where the run without
the interruption ends. Each checkpoint's index entry carries the curves and
the blend history so far, so a resumed run writes them whole. (The JAX
package checkpoints only the improving epochs and always starts at
epoch 0.)

The path of an epoch is the JAX loop's (loop.py:146-231): with
``fused_epoch`` (``TPU.fused_epoch``) and a resident train split the epoch
runs through ``survival_train_epoch`` / ``classification_train_epoch``,
each step a CUDA graph replay on the card, with the validation forward
fused in (``with_val``) when the validation split is resident and no
``eval_chunk`` is asked for; otherwise one step at a time, from a resident
split by ``gather_superbatch`` or from a host split
(``TPU.device_resident_dataset: false``) by ``prefetched_epoch``.
Validation runs every ``val_interval`` epochs; a blend update in an epoch
without validation first recomputes the validation predictions against the
current weights (loop.py:146-153, 353-362). The blend update is copied into
the state's tensors in place, since a captured graph reads them.

Under a mesh of ranks (``state.mesh``) every rank runs the same loop on
the same global batches, and the steps shard them (``train/steps.py``):
the losses, predictions, C-indices, F1s, blend updates and best-model
choices are the same on every rank, and only rank 0 writes files
(``metrics.jsonl``, the ``.npz`` files, checkpoints, curves and CSVs).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import SUPER_BATCH_SIZE
from ..data.loader import DeviceDataset, EpochBatcher, gather_superbatch
from ..data.streaming import HostDataset, prefetched_epoch
from ..ops import blending
from ..ops.losses import pos_weight_from_frequencies
from ..ops.metrics import c_indices_per_class, thresholded_f1s
from ..parallel import mesh
from ..utils.logging import MetricsWriter, get_logger
from ..utils.plotting import (
    LossTracker,
    save_blend_history,
    save_c_score_curves,
    save_f1_curves,
    save_loss_curves,
)
from . import checkpoint as ckpt_lib
from .evaluate import classification_eval_split, survival_eval_split
from .steps import (
    classification_train_epoch,
    classification_train_step,
    survival_train_epoch,
    survival_train_superstep,
)

logger = get_logger()


@dataclass
class LoopConfig:
    epochs: int = 100
    batch_size: int = 8
    super_batch: int = SUPER_BATCH_SIZE
    blend: bool = False
    blend_update_interval: int = 5
    seed: int = 42
    output_dir: str = "."
    val_interval: int = 1
    augment: bool = True
    checkpoint_dir: str = ""
    save_params_name: str = ""
    metrics_path: str = "metrics.jsonl"
    profile_dir: str = ""
    ties: str = "breslow"  # Cox tie handling: "breslow" | "efron"
    # validation forward chunk size; 0 = auto (the whole split when it is
    # device-resident, DEFAULT_EVAL_CHUNK when it streams from the host)
    eval_chunk: int = 0
    # each step of an epoch one CUDA graph replay (TPU.fused_epoch)
    fused_epoch: bool = False
    # bottleneck key layout of the written .npz ("unfused" | "fused")
    npz_layout: str = "unfused"


@dataclass
class TrainResult:
    state: object
    best_metric: float
    best_epoch: int
    history: dict = field(default_factory=dict)


def _writers(cfg: LoopConfig, writes: bool):
    """This rank's (metrics writer, best-model saver, checkpoint saver), or
    None each where the rank does not write (every rank but rank 0); the
    checkpoint saver is None without a checkpoint directory too."""
    if not writes:
        return None, None, None
    return (MetricsWriter(os.path.join(cfg.output_dir, cfg.metrics_path)),
            ckpt_lib.AsyncNpzSaver(cfg.npz_layout),
            ckpt_lib.CheckpointManager(cfg.checkpoint_dir)
            if cfg.checkpoint_dir else None)


def _resumed_metrics(cfg: LoopConfig) -> dict:
    """The newest checkpoint's metrics (each rank reads them)."""
    reader = ckpt_lib.CheckpointManager(cfg.checkpoint_dir)
    return reader.metrics(reader.latest_step())


def _flatten_epoch_preds(preds: np.ndarray, blend: bool) -> np.ndarray:
    """(steps, A, [K,] B, C) -> ([K,] N, C) concatenated along samples."""
    if blend:
        s, a, k, b, c = preds.shape
        return preds.transpose(2, 0, 1, 3, 4).reshape(k, s * a * b, c)
    s, a, b, c = preds.shape
    return preds.reshape(s * a * b, c)


def _dedup_epoch(flat_preds: np.ndarray, n: int, blend: bool) -> np.ndarray:
    """The first ``n`` rows of the epoch prediction stream: the shuffled
    order is followed by the wrap pad, so these are the unique samples."""
    return flat_preds[:, :n] if blend else flat_preds[:n]


def _c_indices(preds, events, durations):
    try:
        return c_indices_per_class(preds, events, durations)
    except ZeroDivisionError:
        return [float("nan")] * preds.shape[1]


def _epoch_batches(ds, batcher: EpochBatcher, epoch: int):
    """One epoch's batches on the device: gathered from a resident split,
    prefetched from a host one."""
    if isinstance(ds, HostDataset):
        yield from prefetched_epoch(ds, batcher, epoch)
    else:
        for idx in batcher.epoch_indices(epoch):
            yield gather_superbatch(ds, idx)


def _fused_paths(train_ds, val_ds, cfg: LoopConfig) -> tuple[bool, bool]:
    """(use_fused, fuse_val) as the JAX loop decides them."""
    use_fused = not isinstance(train_ds, HostDataset) and cfg.fused_epoch
    fuse_val = (use_fused and not isinstance(val_ds, HostDataset)
                and not cfg.eval_chunk)
    return use_fused, fuse_val


def _epoch_rows(batcher: EpochBatcher, epoch: int):
    """(full steps' indices, the ragged tail's or None) of an epoch."""
    order = batcher.epoch_indices(epoch)
    if batcher.ragged:
        return order[:-1], order[-1]
    return order, None


def _on_device(a, device):
    return torch.as_tensor(np.asarray(a)).to(device)


def train_survival(
    state,
    train_ds: DeviceDataset | HostDataset,
    val_ds: DeviceDataset | HostDataset,
    cfg: LoopConfig,
) -> TrainResult:
    use_fused, fuse_val = _fused_paths(train_ds, val_ds, cfg)
    accum = max(1, cfg.super_batch // cfg.batch_size)
    batcher = EpochBatcher(
        train_ds.num_samples, cfg.batch_size, accum, seed=cfg.seed,
        two_level=True,
    )
    writes = mesh.is_writer(state.mesh)
    metrics, npz_saver, saver = _writers(cfg, writes)
    device = train_ds.device

    best_loss, best_epoch, best_c_indices = np.inf, -1, None
    history = {"train_loss": [], "val_loss": [], "train_c": [], "val_c": [],
               "blend": [state.blend.weights.cpu().tolist()]}
    first_epoch = int(state.epoch)
    if cfg.checkpoint_dir and first_epoch:
        done = _resumed_metrics(cfg)
        best_loss = done.get("best_loss", np.inf)
        best_epoch = done.get("best_epoch", -1)
        best_c_indices = done.get("best_c_indices")
        history = done.get("history", history)
    train_losses, val_losses = history["train_loss"], history["val_loss"]
    train_cs, val_cs = history["train_c"], history["val_c"]
    blend_history = history["blend"]
    # the validation predictions a blend update reads, and their epoch:
    # with val_interval > 1 they may be stale and are then recomputed
    val_preds, val_preds_epoch = None, -1

    # host copies of the targets: epoch statistics gather from these
    host_events = train_ds.events.cpu().numpy()
    host_durations = train_ds.durations.cpu().numpy()
    val_events = val_ds.events.cpu().numpy()
    val_durations = val_ds.durations.cpu().numpy()
    n_unique = train_ds.num_samples

    tail_mask = (
        torch.as_tensor(batcher.pad_mask()[-1]).to(device)
        if batcher.ragged else None
    )
    steps_total = batcher.steps_per_epoch()
    # the whole run's rates: a graph reads the table it was captured with
    state.ensure_rates(cfg.epochs * steps_total)

    for epoch in range(first_epoch, cfg.epochs):
        logger.info("-" * 10)
        logger.info(f"epoch {epoch + 1}/{cfg.epochs}")
        profiler = None
        if cfg.profile_dir and epoch == 1 and writes:
            profiler = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA]
                if device.type == "cuda" else []))
            profiler.__enter__()

        epoch_t0 = time.perf_counter()
        do_val = (epoch + 1) % cfg.val_interval == 0
        val_out = None
        if use_fused:
            idx, tail_idx = _epoch_rows(batcher, epoch)
            out = survival_train_epoch(
                state, train_ds, idx, tail_idx, tail_mask,
                val_ds=val_ds if fuse_val else None, blend=cfg.blend,
                augment=cfg.augment, ties=cfg.ties,
                with_val=fuse_val and do_val)
            # one read-back per epoch
            epoch_loss = out["loss"].sum().item()
            preds_host = out["preds"].float().cpu().numpy()
            if fuse_val and do_val:
                val_out = {"preds": out["val_preds"].float().cpu().numpy(),
                           "loss": out["val_loss"].item(),
                           "selection_loss": out["val_selection"].item()}
        else:
            step_losses, step_preds = [], []
            for s, batch in enumerate(_epoch_batches(train_ds, batcher,
                                                     epoch)):
                aux = survival_train_superstep(
                    state, batch["inputs"], batch["events"],
                    batch["durations"], blend=cfg.blend,
                    augment=cfg.augment, ties=cfg.ties,
                    mask=tail_mask if s == steps_total - 1 else None,
                )
                step_losses.append(aux["loss"])
                step_preds.append(aux["preds"])
            # one read-back per epoch
            epoch_loss = torch.stack(step_losses).sum().item()
            preds_host = torch.stack(step_preds).float().cpu().numpy()

        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(cfg.profile_dir, f"epoch{epoch + 1}.json"))

        flat_order = batcher.epoch_indices(epoch).reshape(-1)
        epoch_samples = int(flat_order.size)
        train_preds = _dedup_epoch(
            _flatten_epoch_preds(preds_host, cfg.blend), n_unique, cfg.blend)
        train_events = host_events[flat_order[:n_unique]]
        train_durations = host_durations[flat_order[:n_unique]]
        head0 = train_preds[0] if cfg.blend else train_preds
        train_c = _c_indices(head0, train_events, train_durations)
        train_cs.append(float(np.mean(train_c)))

        epoch_dt = time.perf_counter() - epoch_t0
        epoch_loss = epoch_loss / train_ds.num_samples
        train_losses.append(epoch_loss)
        logger.info(
            f"epoch {epoch + 1} average loss: {epoch_loss:.4f} "
            f"({epoch_samples / max(epoch_dt, 1e-9):.1f} samples/s)"
        )

        selection_loss = None
        if do_val:
            out = val_out if val_out is not None else survival_eval_split(
                state, val_ds, blend=cfg.blend, ties=cfg.ties,
                chunk=cfg.eval_chunk)
            val_preds, val_preds_epoch = out["preds"], epoch
            v_head0 = val_preds[0] if cfg.blend else val_preds
            c_indices = _c_indices(v_head0, val_events, val_durations)
            mean_c = float(np.mean(c_indices))
            val_cs.append(mean_c)
            val_loss = out["loss"] / val_ds.num_samples
            val_losses.append(val_loss)
            selection_loss = out["selection_loss"]
            logger.info(f"All C-indexes: {c_indices}")
            logger.info(f"Mean C-index: {mean_c}")
            logger.info(f"validation loss: {val_loss}")

            if selection_loss < best_loss:
                best_loss = selection_loss
                best_epoch = epoch + 1
                best_c_indices = c_indices
                if cfg.save_params_name and writes:
                    npz_saver.submit(
                        os.path.join(cfg.output_dir, cfg.save_params_name),
                        state.model)
                logger.info("saved new best metric model")
            logger.info(
                f"current epoch: {epoch + 1} current loss: "
                f"{selection_loss:.4f} best loss: {best_loss:.4f} at epoch: "
                f"{best_epoch} best c_indices: {best_c_indices}"
            )
            if writes:
                metrics.write(
                    kind="survival_epoch",
                    epoch=epoch + 1,
                    train_loss=epoch_loss,
                    val_loss=val_loss,
                    train_c=train_cs[-1],
                    val_c=mean_c,
                    selection_loss=selection_loss,
                    epoch_seconds=epoch_dt,
                    samples_per_sec=epoch_samples / max(epoch_dt, 1e-9),
                )

        if cfg.blend and (epoch + 1) % cfg.blend_update_interval == 0:
            if val_preds is None or val_preds_epoch != epoch:
                # no validation this epoch: the kept predictions are missing
                # or stale, so recompute them with the current weights
                val_preds = survival_eval_split(
                    state, val_ds, blend=cfg.blend, ties=cfg.ties,
                    chunk=cfg.eval_chunk)["preds"]
                val_preds_epoch = epoch
            logger.info("Updating gradient blender weights")
            tr_head = blending.surv_head_losses(
                _on_device(train_preds, device),
                _on_device(train_events, device),
                _on_device(train_durations, device), ties=cfg.ties)
            va_head = blending.surv_head_losses(
                _on_device(val_preds, device), _on_device(val_events, device),
                _on_device(val_durations, device), ties=cfg.ties)
            blending.assign_blend(state.blend, blending.blend_update(
                state.blend, tr_head, va_head, True))
            blend_history.append(state.blend.weights.cpu().tolist())
            logger.info(f"new weights : {blend_history[-1]}")

        state.epoch += 1
        if saver is not None:
            saver.save(epoch + 1, state, {
                "selection_metric": (-selection_loss if do_val
                                     else float("-inf")),
                "best_loss": float(best_loss), "best_epoch": best_epoch,
                "best_c_indices": best_c_indices, "history": history})

    if writes:
        if cfg.blend:
            save_blend_history(blend_history, cfg.output_dir)
        save_loss_curves(train_losses, val_losses, cfg.output_dir)
        save_c_score_curves(train_cs, val_cs, cfg.output_dir)
        npz_saver.close()
        metrics.close()
    return TrainResult(
        state=state,
        best_metric=best_loss,
        best_epoch=best_epoch,
        history={
            "train_loss": train_losses,
            "val_loss": val_losses,
            "train_c": train_cs,
            "val_c": val_cs,
            "best_c_indices": best_c_indices,
        },
    )


def train_classification(
    state,
    train_ds: DeviceDataset | HostDataset,
    val_ds: DeviceDataset | HostDataset,
    cfg: LoopConfig,
) -> TrainResult:
    use_fused, fuse_val = _fused_paths(train_ds, val_ds, cfg)
    device = train_ds.device
    host_labels = train_ds.labels.cpu().numpy()
    val_labels = val_ds.labels.cpu().numpy()
    pos_weight = pos_weight_from_frequencies(host_labels.mean(axis=0)).to(
        device)
    batcher = EpochBatcher(train_ds.num_samples, cfg.batch_size, 1,
                           seed=cfg.seed)
    writes = mesh.is_writer(state.mesh)
    metrics, npz_saver, saver = _writers(cfg, writes)

    best_metric, best_epoch, best_f1s = -1.0, -1, None
    history = {"train_loss": [], "val_loss": [], "train_f1": [], "val_f1": [],
               "blend": [state.blend.weights.cpu().tolist()],
               "tracker": LossTracker().curves()}
    first_epoch = int(state.epoch)
    if cfg.checkpoint_dir and first_epoch:
        done = _resumed_metrics(cfg)
        best_metric = done.get("best_metric", best_metric)
        best_epoch = done.get("best_epoch", best_epoch)
        best_f1s = done.get("best_f1s")
        history = done.get("history", history)
    train_losses, val_losses = history["train_loss"], history["val_loss"]
    train_f1s, val_f1s = history["train_f1"], history["val_f1"]
    blend_history = history["blend"]
    tracker = LossTracker(history["tracker"])
    n_unique = train_ds.num_samples
    # see train_survival: the validation logits a blend update reads
    val_logits, val_logits_epoch = None, -1

    tail_mask = (
        torch.as_tensor(batcher.pad_mask()[-1]).to(device)
        if batcher.ragged else None
    )
    steps_total = batcher.steps_per_epoch()
    state.ensure_rates(cfg.epochs * steps_total)

    for epoch in range(first_epoch, cfg.epochs):
        logger.info("-" * 10)
        logger.info(f"epoch {epoch + 1}/{cfg.epochs}")
        epoch_t0 = time.perf_counter()
        do_val = (epoch + 1) % cfg.val_interval == 0
        val_out = None
        if use_fused:
            idx, tail_idx = _epoch_rows(batcher, epoch)
            out = classification_train_epoch(
                state, train_ds, pos_weight, idx, tail_idx, tail_mask,
                val_ds=val_ds if fuse_val else None, blend=cfg.blend,
                augment=cfg.augment, with_val=fuse_val and do_val)
            # one read-back per epoch
            epoch_loss = out["loss"].sum().item()
            logits_host = out["preds"].float().cpu().numpy()
            if fuse_val and do_val:
                val_out = {
                    "preds": out["val_preds"].float().cpu().numpy(),
                    "elementwise": out["val_elementwise"].cpu().numpy(),
                    "loss": out["val_loss"].item()}
        else:
            step_losses, step_logits = [], []
            for s, batch in enumerate(_epoch_batches(train_ds, batcher,
                                                     epoch)):
                aux = classification_train_step(
                    state, batch["inputs"], batch["labels"], pos_weight,
                    blend=cfg.blend, augment=cfg.augment,
                    mask=tail_mask if s == steps_total - 1 else None,
                )
                step_losses.append(aux["loss"])
                step_logits.append(aux["preds"])
            # one read-back per epoch
            epoch_loss = torch.stack(step_losses).sum().item()
            logits_host = torch.stack(step_logits).float().cpu().numpy()

        flat_order = batcher.epoch_indices(epoch).reshape(-1)
        if cfg.blend:  # (S, K, B, C) -> (K, S * B, C)
            s, k, b, c = logits_host.shape
            tr_logits = logits_host.transpose(1, 0, 2, 3).reshape(k, s * b, c)
        else:
            s, b, c = logits_host.shape
            tr_logits = logits_host.reshape(s * b, c)
        tr_logits = _dedup_epoch(tr_logits, n_unique, cfg.blend)
        tr_labels = host_labels[flat_order[:n_unique]]
        *_, f1s = thresholded_f1s(tr_logits[0] if cfg.blend else tr_logits,
                                  tr_labels)
        train_f1s.append(float(np.nanmean(f1s)))
        epoch_dt = time.perf_counter() - epoch_t0
        epoch_loss = epoch_loss / train_ds.num_samples
        train_losses.append(epoch_loss)
        logger.info(
            f"epoch {epoch + 1} average loss: {epoch_loss:.4f} "
            f"({train_ds.num_samples / max(epoch_dt, 1e-9):.1f} samples/s)"
        )

        mean_f1 = -1.0
        if do_val:
            out = val_out if val_out is not None else \
                classification_eval_split(state, val_ds, pos_weight,
                                          blend=cfg.blend,
                                          chunk=cfg.eval_chunk)
            val_logits, val_logits_epoch = out["preds"], epoch
            _, pred_lbl, f1s = thresholded_f1s(
                val_logits[0] if cfg.blend else val_logits, val_labels)
            tracker.update(pred_lbl, val_labels, out["elementwise"])
            val_loss = float(out["elementwise"].sum()) / val_ds.num_samples
            val_losses.append(val_loss)
            logger.info(f"Validation loss: {val_loss}")
            mean_f1 = float(np.nanmean(f1s))
            val_f1s.append(mean_f1)
            if mean_f1 > best_metric:
                best_metric, best_f1s, best_epoch = mean_f1, f1s, epoch + 1
                if cfg.save_params_name and writes:
                    npz_saver.submit(
                        os.path.join(cfg.output_dir, cfg.save_params_name),
                        state.model)
                logger.info("saved new best metric model")
            logger.info(
                f"current epoch: {epoch + 1} current f1: {mean_f1:.4f}"
                f" best f1: {best_metric:.4f} at epoch: {best_epoch}"
            )
            if writes:
                metrics.write(
                    kind="classification_epoch",
                    epoch=epoch + 1,
                    train_loss=epoch_loss,
                    val_loss=val_loss,
                    train_f1=train_f1s[-1],
                    val_f1=mean_f1,
                    epoch_seconds=epoch_dt,
                    samples_per_sec=train_ds.num_samples / max(epoch_dt, 1e-9),
                )

        if cfg.blend and (epoch + 1) % cfg.blend_update_interval == 0:
            # raw logits for both, as the JAX loop (the reference feeds
            # probabilities and 0/1 predictions through BCE-with-logits)
            logger.info("Updating gradient blender weights")
            if val_logits is None or val_logits_epoch != epoch:
                val_logits = classification_eval_split(
                    state, val_ds, pos_weight, blend=cfg.blend,
                    chunk=cfg.eval_chunk)["preds"]
                val_logits_epoch = epoch
            tr_head = blending.class_head_losses(
                _on_device(tr_logits, device), _on_device(tr_labels, device),
                pos_weight)
            va_head = blending.class_head_losses(
                _on_device(val_logits, device), _on_device(val_labels, device),
                pos_weight)
            blending.assign_blend(state.blend, blending.blend_update(
                state.blend, tr_head, va_head, False))
            blend_history.append(state.blend.weights.cpu().tolist())
            logger.info(f"new weights : {blend_history[-1]}")

        state.epoch += 1
        if saver is not None:
            saver.save(epoch + 1, state, {
                "selection_metric": mean_f1 if np.isfinite(mean_f1) else -1.0,
                "best_metric": best_metric, "best_epoch": best_epoch,
                "best_f1s": best_f1s, "history": history})

    if writes:
        tracker.save_plots(cfg.output_dir)
        if cfg.blend:
            save_blend_history(blend_history, cfg.output_dir)
        save_loss_curves(train_losses, val_losses, cfg.output_dir)
        save_f1_curves(train_f1s, val_f1s, cfg.output_dir)
        if cfg.save_params_name:
            ckpt_lib.save_params_npz(
                os.path.join(cfg.output_dir, "final_" + cfg.save_params_name),
                state.model, cfg.npz_layout)
        npz_saver.close()
        metrics.close()
    return TrainResult(
        state=state,
        best_metric=best_metric,
        best_epoch=best_epoch,
        history={
            "train_loss": train_losses,
            "val_loss": val_losses,
            "train_f1": train_f1s,
            "val_f1": val_f1s,
            "best_f1s": best_f1s,
        },
    )
