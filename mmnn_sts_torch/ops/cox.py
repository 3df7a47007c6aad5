"""Cox proportional-hazards partial likelihood (counterpart of the JAX
package's ops/cox.py).

    loss = - sum_{i: event_i=1} [ log_h_i - log( sum_{j: T_j >= T_i} exp(log_h_j) ) ]
           / (number of events)

The batch is sorted by duration, descending, with a stable sort, so the
risk set of patient i is a prefix and ties keep their input order, as in
the JAX package (cox.py:61-63). ``cox_ph_loss_efron`` adds Efron's tie
correction. A ``mask`` (N,) of 0/1 excludes samples from risk sets and event
terms, so the loss is the valid subset's; a batch without events has loss 0.

Every function here takes (N, ...) tensors and treats each trailing index
as an independent column; ``multi_cox_loss`` sums the columns of (N, C).
"""

from __future__ import annotations

import torch


def _sorted(log_h, events, durations, mask):
    """Sort every column by duration, descending (stable), and scale the
    hazards by their largest valid value. Returns ``(lh, ev, dur, w,
    gamma)`` with masked entries' hazards set to gamma, their weights ``w``
    and events to 0 (cox.py:61-81)."""
    log_h = log_h.float()
    events = events.float().expand_as(log_h)
    durations = durations.expand_as(log_h)
    order = torch.argsort(-durations, dim=0, stable=True)
    lh, ev, dur = (t.gather(0, order) for t in (log_h, events, durations))
    if mask is None:
        gamma = lh.amax(0).detach()
        return lh, ev, dur, torch.exp(lh - gamma), gamma
    m = mask.float().view((-1,) + (1,) * (lh.dim() - 1)).expand_as(lh)
    valid = m.gather(0, order) > 0
    ev = ev * valid
    gamma = torch.where(valid, lh, float("-inf")).amax(0)
    gamma = torch.where(torch.isfinite(gamma), gamma, 0.0).detach()
    # clamp masked entries to gamma before exp, so neither where-branch is
    # inf (the where-NaN gradient trap), and use the clamped values in the
    # event terms too, so a non-finite masked log_h cannot give inf * 0
    lh = torch.where(valid, lh, gamma)
    w = torch.where(valid, torch.exp(lh - gamma), 0.0)
    return lh, ev, dur, w, gamma


def cox_ph_loss(log_h, events, durations, eps: float = 1e-7, mask=None):
    """Negative Cox partial log-likelihood (Breslow: no tie correction),
    per column (cox.py:33-86)."""
    lh, ev, _, w, gamma = _sorted(log_h, events, durations, mask)
    log_cumsum_h = torch.log(torch.cumsum(w, 0) + eps) + gamma
    pll = ((lh - log_cumsum_h) * ev).sum(0)
    return -pll / torch.clamp(ev.sum(0), min=1.0)


def cox_ph_loss_efron(log_h, events, durations, eps: float = 1e-7,
                      mask=None):
    """Cox partial likelihood with Efron's tie correction, per column
    (cox.py:89-163): the l-th of d tied events at a time has the
    denominator log(S_R - (l / d) S_D), S_R the risk-set hazard sum and
    S_D the tied events' hazard sum."""
    lh, ev, dur, w, gamma = _sorted(log_h, events, durations, mask)
    n = lh.shape[0]
    idx = torch.arange(n, device=lh.device).view(
        (-1,) + (1,) * (lh.dim() - 1)).expand_as(lh)
    change = dur[1:] != dur[:-1]
    first = torch.ones_like(change[:1])
    # each element's group start (a running max of start positions) and
    # group end (a reversed running min of end positions)
    start_idx = torch.cummax(
        torch.where(torch.cat([first, change]), idx, 0), 0).values
    rev_end = torch.cummin(
        torch.where(torch.cat([change, first]), idx, n - 1).flip(0),
        0).values.flip(0)

    cum_w = torch.cumsum(w, 0)
    cum_we = torch.cumsum(w * ev, 0)
    cum_ev = torch.cumsum(ev, 0)
    has_prev = start_idx > 0
    prev = torch.clamp(start_idx - 1, min=0)

    s_r = cum_w.gather(0, rev_end)
    s_d = cum_we.gather(0, rev_end) - torch.where(
        has_prev, cum_we.gather(0, prev), 0.0)
    start_off_ev = torch.where(has_prev, cum_ev.gather(0, prev), 0.0)
    d_group = cum_ev.gather(0, rev_end) - start_off_ev
    l_i = cum_ev - start_off_ev - 1.0  # rank of this event in its group
    frac = torch.where(d_group > 0, l_i / torch.clamp(d_group, min=1.0), 0.0)
    denom = torch.log(torch.maximum(s_r - frac * s_d,
                                    s_r.new_full((), eps))) + gamma
    pll = ((lh - denom) * ev).sum(0)
    return -pll / torch.clamp(ev.sum(0), min=1.0)


def column_losses(log_h, events, durations, eps: float = 1e-7,
                  ties: str = "breslow", mask=None):
    """Per-column Cox losses of (N, ...) hazards, Breslow or Efron."""
    fn = cox_ph_loss_efron if ties == "efron" else cox_ph_loss
    return fn(log_h, events, durations, eps, mask)


def multi_cox_loss(log_h, events, durations, eps: float = 1e-7,
                   ties: str = "breslow", mask=None):
    """Sum of independent Cox losses over the C columns of (N, C) inputs
    (cox.py:166-193); ``mask`` (N,) is shared by the columns."""
    return column_losses(log_h, events, durations, eps, ties, mask).sum()
