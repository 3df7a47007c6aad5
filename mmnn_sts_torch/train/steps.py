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
"""

from __future__ import annotations

import torch

from ..ops.augment import eval_transform_batch, train_augment_batch
from ..ops.blending import blended_class_loss, blended_surv_loss
from ..ops.cox import multi_cox_loss
from ..ops.losses import bce_with_logits
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


def _survival_loss(state, out, events, durations, blend, ties, mask=None):
    """The loss to train on and the selection loss (the multimodal head's
    own loss under blending, else the same loss)."""
    if blend:
        return blended_surv_loss(state.blend, out, events, durations, ties,
                                 mask)
    loss = multi_cox_loss(out, events, durations, ties=ties, mask=mask)
    return loss, loss


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
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = torch.zeros((), device=events.device)
    outs = []
    for i in range(events.shape[0]):
        mb_mask = None if mask is None else mask[i]
        mb_inputs = _transform_inputs(_microbatch(inputs, i),
                                      generator if augment else None)
        out = model(mb_inputs, sample_mask=mb_mask, generator=generator)
        loss, _ = _survival_loss(state, out, events[i], durations[i], blend,
                                 ties, mb_mask)
        loss.backward()
        loss_sum += loss.detach()
        outs.append(out.detach())
    _apply_gradients(state)
    return {"loss": loss_sum, "preds": torch.stack(outs)}


def _apply_gradients(state: TrainState):
    # optax decays and carries momentum for every parameter; torch's SGD
    # skips a parameter whose .grad is None, so give unused ones zeros
    for p in state.model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    state.apply_gradients()


@torch.no_grad()
def survival_eval_step(state: TrainState, inputs, events, durations,
                       blend: bool = False, ties: str = "breslow"):
    """Validation forward on leaves (B, ...): eval mode (running BatchNorm
    statistics, no dropout) after the eval transform. Returns ``{"loss",
    "selection_loss", "preds"}`` (steps.py:324-334)."""
    out = state.model.eval()(_transform_inputs(inputs))
    loss, selection = _survival_loss(state, out, events, durations, blend,
                                     ties)
    return {"loss": loss, "selection_loss": selection, "preds": out}


def _classification_loss(state, out, labels, pos_weight, blend, mask=None):
    if blend:
        return blended_class_loss(state.blend, out, labels, pos_weight,
                                  mask)[0]
    return bce_with_logits(out, labels, pos_weight, reduction="sum",
                           mask=mask)


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
    generator = state.generator
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    out = model(_transform_inputs(inputs, generator if augment else None),
                sample_mask=mask, generator=generator)
    loss = _classification_loss(state, out, labels, pos_weight, blend, mask)
    loss.backward()
    _apply_gradients(state)
    return {"loss": loss.detach(), "preds": out.detach()}


@torch.no_grad()
def classification_eval_step(state: TrainState, inputs, labels, pos_weight,
                             blend: bool = False):
    """Validation forward on leaves (B, ...): eval mode after the eval
    transform. Returns ``{"loss", "preds", "elementwise"}``, the last the
    (B, C) unreduced BCE of the multimodal head, which the ``LossTracker``
    reads."""
    out = state.model.eval()(_transform_inputs(inputs))
    head = out[0] if blend else out
    elementwise = bce_with_logits(head, labels, pos_weight, reduction="none")
    loss = (_classification_loss(state, out, labels, pos_weight, blend)
            if blend else elementwise.sum())
    return {"loss": loss, "preds": out, "elementwise": elementwise}
