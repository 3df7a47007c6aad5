"""Survival train and eval steps (counterpart of the survival half of the
JAX package's train/steps.py).

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
"""

from __future__ import annotations

import torch

from ..ops.augment import eval_transform_batch
from ..ops.blending import blended_surv_loss
from ..ops.cox import multi_cox_loss
from .state import TrainState


def _eval_transform_inputs(inputs):
    """``eval_transform`` of every volume of the image modality (a dict's
    ``"image"``, or a bare (B, D, H, W, C) batch); clinical rows pass."""
    if isinstance(inputs, dict):
        if "image" not in inputs:
            return inputs
        return {**inputs, "image": eval_transform_batch(inputs["image"])}
    return eval_transform_batch(inputs) if inputs.dim() >= 4 else inputs


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

    ``generator`` feeds dropout (default: ``state.generator``). ``mask``
    (A, B) marks the valid samples of a wrap-padded ragged tail: masked
    samples are left out of the losses, the gradients and the BatchNorm
    statistics (steps.py:176-182, 221-225). ``augment=False`` applies the
    deterministic eval transform; the random training augmentation is not
    ported yet.
    """
    if augment:
        raise NotImplementedError(
            "training augmentation (augment=True) is not ported to "
            "mmnn_sts_torch yet (see ROADMAP.md, Queue 1); pass augment=False")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    generator = state.generator if generator is None else generator
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = torch.zeros((), device=events.device)
    outs = []
    for i in range(events.shape[0]):
        mb_mask = None if mask is None else mask[i]
        out = model(_eval_transform_inputs(_microbatch(inputs, i)),
                    sample_mask=mb_mask, generator=generator)
        loss, _ = _survival_loss(state, out, events[i], durations[i], blend,
                                 ties, mb_mask)
        loss.backward()
        loss_sum += loss.detach()
        outs.append(out.detach())
    # optax decays and carries momentum for every parameter; torch's SGD
    # skips a parameter whose .grad is None, so give unused ones zeros
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    state.apply_gradients()
    return {"loss": loss_sum, "preds": torch.stack(outs)}


@torch.no_grad()
def survival_eval_step(state: TrainState, inputs, events, durations,
                       blend: bool = False, ties: str = "breslow"):
    """Validation forward on leaves (B, ...): eval mode (running BatchNorm
    statistics, no dropout) after the eval transform. Returns ``{"loss",
    "selection_loss", "preds"}`` (steps.py:324-334)."""
    out = state.model.eval()(_eval_transform_inputs(inputs))
    loss, selection = _survival_loss(state, out, events, durations, blend,
                                     ties)
    return {"loss": loss, "selection_loss": selection, "preds": out}
