"""Train and eval steps (counterpart of the JAX package's train/steps.py).

``survival_train_superstep`` is one optimizer update over A microbatches of
B samples, as the JAX package's superstep (steps.py:127-321) and the
reference's gradient accumulation: the microbatches run in order, each in
train mode with its own BatchNorm batch statistics and running-stat update
(carried to the next), each loss is back-propagated into the summed
gradients, then one optimizer step. The summed gradients stay in each
parameter's ``.grad`` until the next superstep.

The JAX package's ``group`` runs microbatches side by side as one program;
it is the same update up to float reassociation (steps.py:154-171), so it
is accepted here and changes nothing.

``classification_train_step`` is one optimizer step per batch, with no
accumulation (steps.py:449-508); ``classification_eval_step`` the
validation forward with its unreduced losses (steps.py:511-521, 594-604).

``survival_train_epoch`` and ``classification_train_epoch`` (steps.py:
341-429, 528-592, ``TPU.fused_epoch``) run a whole epoch over a resident
split: each step gathers its batch by index and runs the same body as the
functions above; a ragged last step runs with its mask, and ``with_val``
adds the validation forward after the last optimizer step. On a CUDA
device each step is one replay of a CUDA graph (``train/graphs.py``): one
graph for the full step, one for the masked tail, one for the validation
forward. On the CPU the same bodies run eagerly over the same buffers.

Under a ``data`` mesh (``state.mesh``, ``parallel/mesh.py``) every rank
passes the same global batch and each step takes this rank's contiguous
rows of each microbatch (``mesh.data_shard``: only where the axis divides
the microbatch, as the JAX loop's ``_data_axis``), runs them ``with
mesh.sharded(shard)`` (BatchNorm statistics over the whole microbatch,
the whole microbatch's random draws), gathers the output rows before the
loss, so every rank holds the global loss and predictions, and sums the
gradients over the ranks before the one optimizer update. The eval steps
forward this rank's rows of the split (a padded last block) and gather
the predictions in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.augment import eval_transform_batch, train_augment_batch
from ..ops.blending import blended_class_loss, blended_surv_loss
from ..ops.cox import multi_cox_loss
from ..ops.losses import bce_with_logits
from ..parallel import mesh
from .graphs import epoch_steps, forward_graph
from .state import TrainState


def _transform_inputs(inputs, generator=None):
    """The image transform of the image modality (a dict's ``"image"``, or
    a bare (B, D, H, W, C) batch); clinical rows pass (steps.py:39-55).
    With a ``generator``, the random training augmentation drawn from it;
    without, the deterministic eval transform."""
    def transform(vols):
        if generator is None:
            return eval_transform_batch(vols)
        return train_augment_batch(vols, generator)

    if isinstance(inputs, dict):
        if "image" not in inputs:
            return inputs
        return {**inputs, "image": transform(inputs["image"])}
    return transform(inputs) if inputs.dim() >= 4 else inputs


def _microbatch(inputs, i: int):
    if isinstance(inputs, dict):
        return {k: v[i] for k, v in inputs.items()}
    return inputs[i]


def _rows(shard, inputs):
    """This rank's rows of a batch's inputs (all of them without a
    shard)."""
    if shard is None:
        return inputs
    if isinstance(inputs, dict):
        return {k: shard.rows(v) for k, v in inputs.items()}
    return shard.rows(inputs)


def _gathered(shard, out, blend):
    """The whole batch's output from each rank's rows (the batch axis is 1
    under blending's (K, B, C) head stack)."""
    return out if shard is None else shard.gather(out, 1 if blend else 0)


def _num_rows(inputs) -> int:
    return next(iter(inputs.values())).shape[0] if isinstance(
        inputs, dict) else inputs.shape[0]


def _eval_forward(model, ranks, inputs, blend):
    """The eval forward of a split's rows, sharded over the ``data`` axis
    of the mesh ``ranks`` where it has one: each rank forwards its block of
    the rows (the last row repeated to make whole blocks; eval rows do not
    interact) and the predictions are gathered in order."""
    shard = mesh.data_shard(ranks)
    if shard is None:
        return model(_transform_inputs(inputs))
    n = _num_rows(inputs)
    whole = -(-n // shard.size) * shard.size

    def take(x):
        if whole > n:
            idx = torch.arange(whole, device=x.device).clamp_(max=n - 1)
            x = x.index_select(0, idx)
        return shard.rows(x)

    local = ({k: take(v) for k, v in inputs.items()}
             if isinstance(inputs, dict) else take(inputs))
    return _gathered(shard, model(_transform_inputs(local)), blend).narrow(
        1 if blend else 0, 0, n)


def _survival_loss(blend_state, out, events, durations, blend, ties,
                   mask=None):
    """The loss to train on and the selection loss (the multimodal head's
    own loss under blending, else the same loss)."""
    if blend:
        return blended_surv_loss(blend_state, out, events, durations, ties,
                                 mask)
    loss = multi_cox_loss(out, events, durations, ties=ties, mask=mask)
    return loss, loss


def _superstep_body(state, blend_state, inputs, events, durations,
                    generator, blend, augment, ties, mask):
    """The superstep's device work: gradients zeroed in place, the
    microbatches' forward and backward, the update at the device step
    counter. ``state.step`` is the caller's."""
    model = state.model.train()
    state.zero_gradients()
    shard = mesh.data_shard(state.mesh, events.shape[1])
    loss_sum = torch.zeros((), device=events.device)
    outs = []
    for i in range(events.shape[0]):
        mb_mask = None if mask is None else mask[i]
        with mesh.sharded(shard):
            mb_inputs = _transform_inputs(_rows(shard, _microbatch(inputs, i)),
                                          generator if augment else None)
            out = _gathered(shard, model(
                mb_inputs, sample_mask=_rows(shard, mb_mask),
                generator=generator), blend)
            loss, _ = _survival_loss(blend_state, out, events[i],
                                     durations[i], blend, ties, mb_mask)
            loss.backward()
        loss_sum += loss.detach()
        outs.append(out.detach())
    if shard is not None:
        shard.sum_gradients(state.gradients())
    state.device_update()
    return {"loss": loss_sum, "preds": torch.stack(outs)}


def survival_train_superstep(
    state: TrainState,
    inputs,  # tensor or dict of tensors, leaves (A, B, ...)
    events: torch.Tensor,  # (A, B, C)
    durations: torch.Tensor,  # (A, B, C)
    generator: torch.Generator | None = None,
    blend: bool = False,
    augment: bool = True,
    ties: str = "breslow",
    group: int = 1,
    mask: torch.Tensor | None = None,
):
    """One optimizer update over A accumulated microbatches; updates
    ``state`` in place and returns ``{"loss": summed loss, "preds":
    (A, [K,] B, C)}``.

    ``generator`` feeds the augmentation and dropout (default:
    ``state.generator``). ``mask`` (A, B) marks the valid samples of a
    wrap-padded ragged tail: masked samples are left out of the losses, the
    gradients and the BatchNorm statistics (steps.py:176-182, 221-225).
    ``augment=True`` augments each microbatch (``ops/augment``, one draw per
    volume); ``augment=False`` applies the deterministic eval transform.
    """
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    generator = state.generator if generator is None else generator
    state.begin_step()
    aux = _superstep_body(state, state.blend, inputs, events, durations,
                          generator, blend, augment, ties, mask)
    state.step += 1
    return aux


@torch.no_grad()
def survival_eval_step(state: TrainState, inputs, events, durations,
                       blend: bool = False, ties: str = "breslow"):
    """Validation forward on leaves (B, ...): eval mode (running BatchNorm
    statistics, no dropout) after the eval transform. Returns ``{"loss",
    "selection_loss", "preds"}`` (steps.py:324-334)."""
    return _survival_eval_body(state.model, state.mesh, state.blend, inputs,
                               events, durations, blend, ties)


@torch.no_grad()
def _survival_eval_body(model, ranks, blend_state, inputs, events,
                        durations, blend, ties):
    out = _eval_forward(model.eval(), ranks, inputs, blend)
    loss, selection = _survival_loss(blend_state, out, events, durations,
                                     blend, ties)
    return {"loss": loss, "selection_loss": selection, "preds": out}


def _classification_loss(blend_state, out, labels, pos_weight, blend,
                         mask=None):
    if blend:
        return blended_class_loss(blend_state, out, labels, pos_weight,
                                  mask)[0]
    return bce_with_logits(out, labels, pos_weight, reduction="sum",
                           mask=mask)


def _classification_body(state, blend_state, inputs, labels, pos_weight,
                         blend, augment, mask):
    """The classification step's device work (see ``_superstep_body``)."""
    generator = state.generator
    model = state.model.train()
    state.zero_gradients()
    shard = mesh.data_shard(state.mesh, labels.shape[0])
    with mesh.sharded(shard):
        local = _transform_inputs(_rows(shard, inputs),
                                  generator if augment else None)
        out = _gathered(shard, model(local, sample_mask=_rows(shard, mask),
                                     generator=generator), blend)
        loss = _classification_loss(blend_state, out, labels, pos_weight,
                                    blend, mask)
        loss.backward()
    if shard is not None:
        shard.sum_gradients(state.gradients())
    state.device_update()
    return {"loss": loss.detach(), "preds": out.detach()}


def classification_train_step(
    state: TrainState,
    inputs,  # tensor or dict of tensors, leaves (B, ...)
    labels: torch.Tensor,  # (B, C)
    pos_weight,
    blend: bool = False,
    augment: bool = True,
    mask: torch.Tensor | None = None,
):
    """One optimizer step on one batch; updates ``state`` in place and
    returns ``{"loss": summed loss, "preds": ([K,] B, C)}``. ``mask`` (B,)
    marks the valid samples of a wrap-padded ragged batch (left out of the
    loss, the gradients and the BatchNorm statistics); ``state.generator``
    feeds the augmentation and dropout."""
    state.begin_step()
    aux = _classification_body(state, state.blend, inputs, labels,
                               pos_weight, blend, augment, mask)
    state.step += 1
    return aux


@torch.no_grad()
def classification_eval_step(state: TrainState, inputs, labels, pos_weight,
                             blend: bool = False):
    """Validation forward on leaves (B, ...): eval mode after the eval
    transform. Returns ``{"loss", "preds", "elementwise"}``, the last the
    (B, C) unreduced BCE of the multimodal head, which the ``LossTracker``
    reads."""
    return _classification_eval_body(state.model, state.mesh, state.blend,
                                     inputs, labels, pos_weight, blend)


@torch.no_grad()
def _classification_eval_body(model, ranks, blend_state, inputs, labels,
                              pos_weight, blend):
    out = _eval_forward(model.eval(), ranks, inputs, blend)
    head = out[0] if blend else out
    elementwise = bce_with_logits(head, labels, pos_weight, reduction="none")
    loss = (_classification_loss(blend_state, out, labels, pos_weight, blend)
            if blend else elementwise.sum())
    return {"loss": loss, "preds": out, "elementwise": elementwise}


# ---------------------------------------------------------------------------
# Whole epochs (TPU.fused_epoch)
# ---------------------------------------------------------------------------


def _run_epoch(state, ds, idx, tail_idx, tail_mask, names, body, flags):
    """The steps of one epoch through the step bodies of ``body``
    (``graphs.EpochSteps``): a full step a row of ``idx``, then the masked
    tail. Returns the epoch's ``loss`` and ``preds`` (one row a step, the
    tail's last)."""
    rows = [("step", i, None) for i in idx]
    if tail_idx is not None:
        rows.append(("tail", tail_idx, tail_mask))
    if not rows:
        raise ValueError("an epoch needs at least one step")
    shape = tuple(np.shape(rows[0][1]))
    state.ensure_rates(state.step + len(rows))
    epoch = epoch_steps(state, (id(ds), shape, len(rows)) + flags, ds, names,
                        shape, len(rows), body)
    for slot, (kind, step_idx, mask) in enumerate(rows):
        state.begin_step()
        out = epoch.run(kind, step_idx, slot, mask)
        state.step += 1
    return {"loss": out["loss"].clone(), "preds": out["preds"].clone()}


def _forward(state, key, forward, ds, names):
    def reads():
        inputs = ds.model_inputs()
        return ((list(inputs.values()) if isinstance(inputs, dict)
                 else [inputs]) + [getattr(ds, n) for n in names])

    out = forward_graph(state, key, forward, reads).run()
    return {k: v.clone() for k, v in out.items()}


def survival_train_epoch(
    state: TrainState,
    train_ds,  # resident split: DeviceDataset with events and durations
    idx,  # (S, A, B) integer indices into train_ds, one row a superstep
    tail_idx=None,  # (A, B): the ragged last superstep
    tail_mask=None,  # (A, B) 0/1 validity of tail_idx
    val_ds=None,  # resident validation split, for ``with_val``
    blend: bool = False,
    augment: bool = True,
    ties: str = "breslow",
    with_val: bool = False,
):
    """A whole training epoch (steps.py:341-429): one superstep a row of
    ``idx``, each gathering its (A, B, ...) batch from the resident split
    by index, then the masked tail, then with ``with_val`` the validation
    forward on ``val_ds`` after the last optimizer step. Updates ``state``
    in place (``step`` counts every superstep); returns ``{"loss":
    (S[+1],), "preds": (S[+1], A, [K,] B, C)}`` and with ``with_val``
    ``val_preds``, ``val_loss`` and ``val_selection``."""
    def body(state, blend_state, batch, mask):
        return _superstep_body(state, blend_state, batch["inputs"],
                               batch["events"], batch["durations"],
                               state.generator, blend, augment, ties, mask)

    out = _run_epoch(state, train_ds, idx, tail_idx, tail_mask,
                     ("events", "durations"), body,
                     ("survival", blend, augment, ties))
    if with_val:
        def val(blend_state):
            return _survival_eval_body(
                state.model, state.mesh, blend_state, val_ds.model_inputs(),
                val_ds.events, val_ds.durations, blend, ties)

        ev = _forward(state, ("survival_val", id(val_ds), blend, ties), val,
                      val_ds, ("events", "durations"))
        out.update(val_preds=ev["preds"], val_loss=ev["loss"],
                   val_selection=ev["selection_loss"])
    return out


def classification_train_epoch(
    state: TrainState,
    train_ds,  # resident split: DeviceDataset with labels
    pos_weight: torch.Tensor,  # (C,) on the split's device
    idx,  # (S, B) integer indices, one row a step
    tail_idx=None,  # (B,): the ragged last batch
    tail_mask=None,  # (B,) 0/1 validity of tail_idx
    val_ds=None,
    blend: bool = False,
    augment: bool = True,
    with_val: bool = False,
):
    """A whole classification epoch (steps.py:528-592): one optimizer step
    a row of ``idx``, then the masked tail, then with ``with_val`` the
    validation forward. Returns ``{"loss": (S[+1],), "preds": (S[+1], [K,]
    B, C)}`` and with ``with_val`` ``val_preds``, ``val_elementwise`` and
    ``val_loss``."""
    def body(state, blend_state, batch, mask):
        return _classification_body(state, blend_state, batch["inputs"],
                                    batch["labels"], pos_weight, blend,
                                    augment, mask)

    out = _run_epoch(state, train_ds, idx, tail_idx, tail_mask, ("labels",),
                     body, ("classification", id(pos_weight), blend, augment))
    if with_val:
        def val(blend_state):
            return _classification_eval_body(
                state.model, state.mesh, blend_state, val_ds.model_inputs(),
                val_ds.labels, pos_weight, blend)

        ev = _forward(state, ("classification_val", id(val_ds),
                              id(pos_weight), blend), val, val_ds, ("labels",))
        out.update(val_preds=ev["preds"], val_elementwise=ev["elementwise"],
                   val_loss=ev["loss"])
    return out
