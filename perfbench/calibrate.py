"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 -m perfbench.calibrate --workload <cell> --seeds 11,12,... \\
        [--controls 3] [--witness] [--out calibrate.jsonl]

For each seed, in one process: the program's set-up and one window epoch
(as a benchmark run makes them), then every number of
``check.readings`` for

* ``program``: the program against the float32 reference (the lower
  reading is the largest of these over the seeds);

and on the first ``--controls`` seeds, against the same reference:

* ``control_fp8``: the reference itself computed in float8 e4m3 at the
  configuration's cast points (the control of a configuration computing
  in bfloat16);
* ``half_batch``: the reference with the second half of every microbatch
  left out, the loss taken over the rest (a planted fault);
* ``answer_altered``: the program's validation predictions with the first
  patient's negated (a planted fault; only ``val_gap`` reads it).

Beside the numbers, for the look (``look``): the worst leaf's gradient and
change gaps with the four worst leaves, each followed superstep's loss
gap and the validation predictions' relative L2 gap; with ``--witness``,
on the control seeds also
``witness_bf16``, the reference rounded to bfloat16 at the control's
points (how far bfloat16 alone moves each number).

A state left unchanged reads 1 in every gradient and change gap (the
program's momentum and change are zero) and needs no run. The control of
a float32 configuration is the program's own bfloat16 path: its readings
are the ``program`` readings of the bfloat16 cell of the same
configuration on the same seeds. Each line of ``--out`` is one seed's
readings, and a summary of the largest and smallest is printed last.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check
from .cells import resolve
from .training import run_program


def look(side: dict, ref: dict) -> dict:
    """What the look at one side's readings needs beyond the numbers."""
    grads = check.leaf_gaps(side["first_grad"], ref["first_grad"])
    changes = check.leaf_gaps(side["change"], ref["change"],
                              check.quiet_leaves(ref))
    vp, vr = side["val_preds"].float(), ref["val_preds"].float()
    return {"grad_gap": grads[0][0], "update_gap": changes[0][0],
            "worst_grad_leaves": grads[:4],
            "worst_update_leaves": changes[:4],
            "step_loss_gaps": [abs(p - r) / abs(r) for p, r in
                               zip(side["losses"], ref["losses"])],
            "val_rel_l2": float(torch.linalg.vector_norm(vp - vr)
                                / torch.linalg.vector_norm(vr))}


def calibrate(cell, seeds, controls: int, device, out=None,
              witness: bool = False) -> dict:
    """Each seed's readings (printed, and written to ``out`` where given)
    and their summary."""
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = run_program(cell, seed, 0.0, False, device, t0)
        t1 = time.perf_counter()
        ref = check.reference_side(cell, run, device)
        prog = check.program_side(run, ref["weights"])
        row = {"cell": cell.name, "seed": seed,
               "program": check.readings(prog, ref),
               "look": {"program": look(prog, ref)},
               "reference_s": time.perf_counter() - t1}
        if i < controls:
            sides = [("control_fp8", {"precision": "fp8"}),
                     ("half_batch", {"half_batch": True})]
            if witness:
                sides.append(("witness_bf16", {"precision": "bfloat16"}))
            for side, kwargs in sides:
                got = check.reference_side(cell, run, device, **kwargs)
                row[side] = check.readings(got, ref)
                row["look"][side] = look(got, ref)
                del got
            altered = run.val_preds.clone()
            altered[..., 0, :] = -altered[..., 0, :]
            row["answer_altered"] = check.readings(
                {**prog, "val_preds": altered}, ref)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out is not None:
            out.write(json.dumps(row) + "\n")
            out.flush()
        del run, ref, prog
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"cell": cell.name, "seeds": len(rows)}
    for side in ("program", "control_fp8", "witness_bf16", "half_batch",
                 "answer_altered"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = {k: {"min": min(g[k] for g in got),
                                 "max": max(g[k] for g in got)}
                             for k in check.NUMBERS}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--witness", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        calibrate(resolve(args.workload), seeds, args.controls,
                  torch.device("cuda", 0), out, args.witness)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
