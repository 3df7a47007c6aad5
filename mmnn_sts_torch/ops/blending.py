"""Gradient blending (counterpart of the JAX package's ops/blending.py;
Wang et al., arXiv:1905.12681).

K = 3 heads, head 0 the multimodal one. The loss is the blend weights
(held constant under autograd) times each head's summed loss: the
multi-target Cox loss for survival, BCE-with-logits for classification.
The weights start uniform and are updated once per epoch from the
per-head train and validation losses (blending.py:119-154). The survival
update uses dG = Lv_N - Lv, the classification update dG = Lv - Lv_N:
``blend_update`` keeps both conventions, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cox import column_losses
from .losses import bce_with_logits


@dataclass
class BlendState:
    """Blend weights and the losses of the previous update, all float32."""

    weights: torch.Tensor  # (K,) softmax-normalised head weights
    lvn: torch.Tensor  # (K,) validation loss at the previous update
    ltn: torch.Tensor  # (K,) training loss at the previous update
    has_history: bool = False  # False until the first update


def blend_init(num_heads: int, device=None) -> BlendState:
    k = num_heads
    return BlendState(
        weights=torch.full((k,), 1.0 / k, device=device),
        lvn=torch.zeros(k, device=device),
        ltn=torch.zeros(k, device=device),
    )


def surv_head_losses(preds, events, durations, ties: str = "breslow",
                     mask=None):
    """(K,) summed multi-target Cox loss of each head; preds (K, N, C),
    events and durations (N, C), mask (N,)."""
    per_column = column_losses(preds.movedim(0, 1), events[:, None],
                               durations[:, None], ties=ties, mask=mask)
    return per_column.sum(-1)


def blended_surv_loss(state: BlendState, preds, events, durations,
                      ties: str = "breslow", mask=None):
    """``(sum(weights * head_losses), head_losses[0])``: the weighted loss
    to train on, and the multimodal head's own loss, which selects the
    best model (blending.py:73-84)."""
    head_losses = surv_head_losses(preds, events, durations, ties, mask)
    return (state.weights.detach() * head_losses).sum(), head_losses[0]


def class_head_losses(preds, targets, pos_weight=None, mask=None):
    """(K,) summed BCE-with-logits loss of each head; preds (K, N, C)."""
    per_element = bce_with_logits(preds, targets, pos_weight,
                                  reduction="none")
    if mask is not None:
        per_element = per_element * mask.float()[None, :, None]
    return per_element.sum((1, 2))


def blended_class_loss(state: BlendState, preds, targets, pos_weight=None,
                       mask=None):
    """``(sum(weights * head_losses), head_losses[0])`` of the
    classification heads (blending.py:96-107)."""
    head_losses = class_head_losses(preds, targets, pos_weight, mask)
    return (state.weights.detach() * head_losses).sum(), head_losses[0]


def class_elementwise_losses(preds, targets, pos_weight=None):
    """(K, N, C) unreduced BCE losses of each head (blending.py:110-116)."""
    return bce_with_logits(preds, targets, pos_weight, reduction="none")


def blend_update(state: BlendState, train_loss, val_loss,
                 survival: bool) -> BlendState:
    """The weight update from (K,) per-head epoch losses: softmax of
    dG / dO^2 with dO = (Lv - Lt) - (Lv_N - Lt_N); the first update gives
    uniform weights (blending.py:119-154)."""
    train_loss = torch.as_tensor(train_loss, dtype=torch.float32,
                                 device=state.weights.device)
    val_loss = torch.as_tensor(val_loss, dtype=torch.float32,
                               device=state.weights.device)
    k = state.weights.shape[0]
    if state.has_history:
        o_n = state.lvn - state.ltn
        o_npn = val_loss - train_loss
        delta_g = state.lvn - val_loss if survival else val_loss - state.lvn
        weights = torch.softmax(delta_g / torch.square(o_npn - o_n), 0)
    else:
        weights = torch.full_like(state.weights, 1.0 / k)
    return BlendState(weights=weights, lvn=val_loss.clone(),
                      ltn=train_loss.clone(), has_history=True)
