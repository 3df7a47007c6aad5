"""The comparison that decides ``correct``: the program's warm-up epochs,
followed by the plain reference (``reference/``) from the seed's weights
on the same inputs, superstep for superstep, the masked tails included;
then the validation forward of the last warm-up epoch (the first graphed
one), which the reference computes on its own weights and running
statistics.

The numbers (``readings``); a cell compares those its
``limits/<cell>.json`` names, each against a limit of its own, with the
readings the limit was set from beside it:

* ``loss_gap``: the worst followed superstep's relative gap in the summed
  loss, ``|L - L_ref| / |L_ref|``;
* ``loss_gap_early``: the same over the first three supersteps alone,
  before train-mode BatchNorm has carried a rounding forward through many
  updates (a gap grows from superstep to superstep in any precision);
* ``grad_gap_median``: over the parameters ("leaves"), the median leaf's
  gap between the norms of the first gradient as the optimizer takes it
  (with the weight decay; the program's is its momentum after one step,
  ``buf = g``), ``| |g| - |g_ref| | / max(|g_ref|, median leaf's
  |g_ref|)``;
* ``update_gap_median``: the same of each leaf's change over the first
  three supersteps, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (biases that the Cox loss or a
  following BatchNorm cannot see, which move by rounding alone);
* ``pred_gap``: the worst followed superstep's training predictions (the
  graphed train-mode forward of every microbatch, the pad rows of a tail
  left out) against the reference's, ``max |p - p_ref| / max |p_ref|``;
* ``val_gap``: the validation predictions against the reference's, the
  same way.

The worst leaf is not steady from seed to seed in bfloat16 (a leaf whose
true gradient is about zero, such as the stem BatchNorm's scale, reads its
rounding), so the cells compare the medians; ``calibrate.py`` reports the
worst leaves beside them.

The reference follows the program's inputs, not its outputs: the weights
and cohort of the seed, each epoch's row order from the loop's seed, the
augmentation's and dropout's draws from a generator of the loop's seed in
the order the model draws them.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import inputs
from .reference import train as ref_train

NUMBERS = ("loss_gap", "loss_gap_early", "grad_gap_median",
           "update_gap_median", "pred_gap", "val_gap")
QUIET_GRAD = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in leaves.items()}


def median(values) -> float:
    values = sorted(values)
    n = len(values)
    return 0.5 * (values[(n - 1) // 2] + values[n // 2])


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list[tuple]:
    """Each leaf's ``(| |p| - |r| | / max(|r|, median |r|), name, |r| /
    median |r|)``, the worst first (a NaN first of all)."""
    if set(prog) != set(ref):
        raise KeyError(f"leaves differ: {sorted(set(prog) ^ set(ref))[:5]}")
    keys = [k for k in ref if keep is None or k in keep]
    rn, pn = _norms({k: ref[k] for k in keys}), _norms(
        {k: prog[k] for k in keys})
    med = max(median(rn.values()), 1e-30)
    gaps = [(abs(pn[k] - rn[k]) / max(rn[k], med), k, rn[k] / med)
            for k in keys]
    return sorted(gaps, key=lambda g: (not math.isnan(g[0]), -g[0]
                                       if not math.isnan(g[0]) else 0))


def quiet_leaves(ref: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: those whose change counts."""
    gn = _norms(ref["first_grad"])
    med = median(gn.values())
    return {k for k, v in gn.items() if v >= QUIET_GRAD * med}


def readings(prog: dict, ref: dict) -> dict:
    """Every number of one side (``prog``) against the reference; each
    side a dict of ``losses``, ``preds``, ``first_grad``, ``change`` and
    ``val_preds``, the reference's also of ``early_steps`` and
    ``pred_valid`` (the rows of a tail that are not pad). A cell compares
    those its limits file names."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in
            zip(prog["losses"], ref["losses"], strict=True)]
    out = {"loss_gap": max(gaps),
           "loss_gap_early": max(gaps[:ref["early_steps"]])}
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"])
    changes = leaf_gaps(prog["change"], ref["change"], quiet_leaves(ref))
    out["grad_gap_median"] = median([g[0] for g in grads])
    out["update_gap_median"] = median([g[0] for g in changes])
    valid = ref["pred_valid"]
    out["pred_gap"] = max(
        _gap(p * _rows(v, p), r * _rows(v, r)) for p, r, v in
        zip(prog["preds"], ref["preds"], valid, strict=True))
    out["val_gap"] = _gap(prog["val_preds"], ref["val_preds"])
    return out


def _gap(p, r) -> float:
    """``max |p - r| / max |r|``."""
    p, r = p.float(), r.float()
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


def _rows(valid, preds):
    """(A, B) row validity shaped to broadcast over (A, [K,] B, C)."""
    a, b = valid.shape
    return valid.view((a,) + (1,) * (preds.dim() - 3) + (b, 1)).to(
        preds.dtype)


def program_side(run, weights: dict) -> dict:
    return {"losses": run.step_losses, "first_grad": run.first_momentum,
            "change": {k: run.params_after[k] - weights[k]
                       for k in run.params_after},
            "preds": torch.cat(run.step_preds), "val_preds": run.val_preds}


def _superbatch(split: dict, rows, multimodal: bool):
    idx = torch.as_tensor(rows.reshape(-1), device=split["image"].device)
    shape = tuple(rows.shape)

    def take(x):
        return x.index_select(0, idx).view(shape + tuple(x.shape[1:]))

    feats = ({"image": take(split["image"]),
              "clinical": take(split["clinical"])} if multimodal
             else take(split["image"]))
    return feats, take(split["events"]), take(split["durations"])


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions within."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def reference_side(cell, run, device, precision: str = "float32",
                   half_batch: bool = False) -> dict:
    """The reference's readings on the run's inputs, TF32 off: the
    program's warm-up epochs from the seed's weights (``precision``;
    ``half_batch`` plants the fault of that name), then the eval forward
    of the validation split on the state they leave."""
    with no_tf32():
        return _reference_side(cell, run, device, precision, half_batch)


def _reference_side(cell, run, device, precision, half_batch):
    model_cfg = cell.config["model"]
    hp = cell.config["Hyperparameters"]
    multimodal = cell.config["flags"]["preop"]
    weights = inputs.make_weights(cell, run.seeds["weights"], device)
    trainer = ref_train.Trainer(
        cell.family().build(model_cfg, precision).to(device), weights, hp,
        run.steps_per_epoch, cell.config["flags"]["blend"])
    train = run.cohort["train"]
    n = train["image"].shape[0]
    micro = hp["train_batch_size"]
    accum = cell.traffic["super_batch"] // micro
    valid = torch.as_tensor(ref_train.pad_mask(n, accum, micro),
                            device=device)
    gen = torch.Generator(device=device).manual_seed(run.seeds["loop"])
    losses, preds, first, change = [], [], None, None
    for epoch in range(run.followed_epochs):
        order = ref_train.epoch_order(run.seeds["loop"], n, accum, micro,
                                      epoch)
        for s in range(len(order)):
            x, ev, dur = _superbatch(train, order[s], multimodal)
            tail = s == len(order) - 1 and n % (accum * micro) != 0
            loss, out, grads = trainer.superstep(
                x, ev, dur, gen, augment=cell.traffic["augment"],
                half_batch=half_batch, mask=valid[s] if tail else None)
            losses.append(loss)
            preds.append(out)
            first = grads if first is None else first
            if len(losses) == run.checked_steps:
                change = {k: p.detach() - weights[k]
                          for k, p in trainer.params.items()}
    return {"losses": losses, "early_steps": run.checked_steps,
            "preds": torch.stack(preds),
            "pred_valid": valid.repeat(run.followed_epochs, 1, 1),
            "first_grad": first, "change": change,
            "val_preds": trainer.evaluate(_val_inputs(cell, run)),
            "weights": weights}


def _val_inputs(cell, run):
    val = run.cohort["val"]
    return ({"image": val["image"], "clinical": val["clinical"]}
            if cell.config["flags"]["preop"] else val["image"])


def judge(values: dict, limits: dict, failed_steps: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number the cell's
    limits name at or under its limit, and no superstep of the window with
    a non-finite loss."""
    checks = {k: {"value": values[k], "limit": v["limit"]}
              for k, v in limits.items()}
    checks["failed_steps"] = {"value": failed_steps, "limit": 0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
