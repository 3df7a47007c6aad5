#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmnn_sts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure is an uncaught exception and a nonzero exit:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all at once) and prints the seconds taken.
3. Kernel: calls fused_bn_relu_matmul on the card at every (M, Cin) shape of
   DenseNet121's 58 bottlenecks at 64^3, for every batch bucket of the
   servable (1, 2, 4, 8, 16, 32), in float32 (fused_bn_relu_matmul.cu, the
   CUDA cores) and bfloat16 (fused_bn_relu_matmul_bf16.cu, the tensor
   cores), and holds each
   result against the plain PyTorch version on the same inputs: max
   |kernel - plain| / max |plain| <= 1e-4 in float32 (sums in another
   order) and 2e-2 in bfloat16 (output rounded to bfloat16). Each shape
   also must give the same bits in two calls, and with a NaN in x the
   kernel's NaN rows must be the plain version's. Prints each shape's
   launch plan (tile, K-split, CTAs). Times the kernel, the plain version
   and torch.matmul of the product alone (a yardstick, not the same
   function) with CUDA events, inputs warm in L2: device time (calls
   queued behind a sleeping kernel), paced time (no sleep: the host's
   launch cost shows where it exceeds the device's) and the host's time
   to enqueue a call, beside the least time the card could take, and
   each block's share of that bound. Then times every launch plan each
   kernel takes at every shape of buckets 1, 8 and 32, each checked
   against the plain version, beside the plan launch_plan picks
   (plan_sweep.jsonl in the output directory). Then the same checks at every
   bottleneck shape of densenet169, densenet201 and densenet264 at batch 8
   (82, 98 and 130 calls, K up to 2,656), in both dtypes; densenet264's 130
   timed per block beside the plain version, the product alone and the
   bound; and every plan of both kernels where their K exceeds
   DenseNet121's largest (992): block 3 at M = 512 and block 4 at M = 64.
4. Serve: the flagship model at full width (DenseNet121-3D at 64^3 x 2ch +
   the 11-feature clinical MLP, blend heads), with weights drawn with numpy
   from --seed in the JAX package's flat key layout (unfused names) and
   carried across with convert.py, exported with export_forward and served
   by ModelServer on the card on an ephemeral port. npz requests of batch 1,
   3 and 8 (six rounds; the first warms up). Each answer must be (B, 2) and
   finite, each served forward must launch the kernel exactly 58 times, and
   the answers must match the same servable run with the plain op in place
   of the kernel on the same card (max |diff| <= 1e-3 * max(1, max |plain|):
   only the bottleneck differs, the convolutions run in cuDNN's default
   TF32 on both sides) and, for batch 1, the same servable on the CPU
   (<= 1e-2 * max(1, max |cpu|): TF32 convolutions against float32 ones).
   Then one batch-8 forward of the servable (no HTTP) is timed on the host
   clock, the host time of the fused op's calls in it is read, and it is
   traced with torch.profiler: CUDA kernel time by name, and the device's
   busy share of the forward.
5. Backward: the fused op under autograd (FusedBnReluMatmul: the kernel
   forward, then the JAX package's _bwd in plain PyTorch) at DenseNet121's
   58 bottleneck shapes at microbatch 8, each with a NaN row in x: dx, da,
   db and dw against torch autograd through the plain version, NaN at the
   same places and the rest within 1e-4 x max |plain|; its device time
   beside the plain version's backward, the two products alone and the
   bound.
6. Train: the flagship survival superstep (8 microbatches of 8 at 64^3,
   float32, blend heads, augment off), weights as in the serve phase,
   synthetic MRI-like volumes, clinical rows and events with tied
   durations. With cuDNN's TF32 off, one superstep with the kernel and one
   with the plain op patched in, from the same state with dropout 0: the
   kernel must launch exactly 58 x 8 = 464 times, and the losses, the
   predictions, every summed gradient and every running statistic must
   agree within 1e-2 x max(1, max |plain|); a third superstep with the
   plain op's product summed in another order shows how far roundoff
   alone moves them. One
   superstep with a ragged-tail mask: a finite loss and finite gradients.
   Then, with cuDNN's TF32 on (PyTorch's
   default) and dropout 0.2 as configured: a warm-up and 6 timed
   supersteps (CUDA events; volumes/s, peak memory), one profiled
   superstep (device busy share, kernel time by kind, the fused kernel's
   and the backward's shares), two validation steps with their C-indices
   and two blend updates. The first and the last superstep draw the same
   dropout masks (the generator is rewound), and the last one's loss on
   the fixed batch must be below the first's. Then the same superstep with
   the training augmentation on (augment=True, as the run trains): a
   warm-up and 6 timed supersteps (volumes/s, peak memory) and one
   profiled superstep: the augmentation's device ms and launches (its
   calls run inside a profiler range) and the busy share.
7. Train in bfloat16: the same flagship model with TPU.compute_dtype
   bfloat16 (float32 parameters, compute in bfloat16 at the JAX package's
   cast points), the augmented superstep 8 x 8 at 64^3 with dropout 0.2.
   One superstep from the same state and draws with the kernel, one with
   the plain op and one with the plain op's product summed in two halves
   of K (the control): the kernel must launch 464 times, every call with
   bfloat16 x and w, and the update (new - old over all parameters) with
   the kernel must lie within BF16_CONTROL_FACTOR x the control's relative
   L2 distance of the plain op's. Then a warm-up and 6 timed supersteps
   (volumes/s, peak memory) and one profiled superstep (busy share,
   kernel time by kind).
8. Families: every other image model the registry builds (tinycnn,
   monaidensenet, densenet169, densenet201, densenet264, seresnet50,
   r3d_18), image-only at full width (Config() defaults, 64^3 x 2ch,
   random weights from --seed) with cuDNN's TF32 off: an eval forward of
   8 (finite (8, 2); the kernel launched 58 / 58 / 82 / 98 / 130 times for
   the DenseNets, 0 for the others), one augmented survival superstep of
   2 x 8 with the kernel and one with the plain op patched in from the
   same state and draws (loss, predictions, every summed gradient and
   running statistic within 1e-2 x max(1, |plain|); launches 2 x the
   forward's; the peak memory), a timed superstep, and a bfloat16 eval
   forward (finite, every kernel call with bfloat16 x and w).
9. Remat: the flagship superstep (8 x 8, dropout 0.2, augment off, TF32
   off) with TPU.remat off and on from the same weights and generator:
   loss, predictions, summed gradients and running statistics within
   1e-2 x max(1, |off|); launches 464 and 920 (every wrapped bottleneck's
   forward runs again in the backward; the Grad-CAM target layer is not
   wrapped); both peak memories and superstep times.
10. CLI: the survival run as a user starts it, at full width. A synthetic
   cohort written without pandas (the csv module and the port's
   save_nifti): CLI_PATIENTS patients, T1 and T2 NIfTI volumes of
   CLI_VOLUME voxels (squared normals x 500, a mask inside), a clinical CSV
   with the real column names and types (dates, categoricals, % necrosis),
   a patient key, and a JSON config (densenet121, t1t2, 64^3 x 2ch). Then
   mmnn_sts_torch.cli.main in this process: --images --preop --survival
   --blend --split --epochs 3 --blend_update_interval 1 --checkpoint_dir.
   Checked: rc 0, the uid files, 3 survival_epoch rows with finite losses
   and C-indices in [0, 1], blend weights that moved and sum to 1, a
   best_surv_model.npz that loads strictly into a fresh port model, and
   kernel launches = supersteps x 464 + validation forwards x 58. Then
   --resume for a 4th epoch (the step counter must carry on, and the blend
   history keeps the first run's rows), then
   python3 -m mmnn_sts_torch --export_path as a subprocess with the best
   weights, and ServingModel on the card answers a batch-3 request with a
   finite (3, 2). Prints the cohort build's seconds, each epoch's seconds
   and samples/s, the best save's host stall and the artifacts written.
11. Inference and classification, on the CLI phase's cohort and best
   weights, through mmnn_sts_torch.cli.main at full width: --inference
   --survival --blend with Grad-CAM on the 15 test patients (rc 0, a
   finite survival_model_predictions.csv row a patient, one
   _patient_{uid}/ directory a patient with four 64^3 NIfTI volumes, each
   att_map in [0, 1] with its max above 0.5, kernel launches = 58 x (eval
   steps + 2 x patients)); one patient's maps with the kernel against the
   plain op on the card (<= 1e-3, cuDNN TF32 off) and against the CPU
   (<= 1e-2); --bootstrap --no_gradcam (50 resamples, means and stds in
   [0, 1], the resamples' C-indices on the card against the CPU <= 1e-6,
   and their device time); --classification --split --epochs 2 in a run
   directory of its own (2 classification_epoch rows, F1s in [0, 1] or
   NaN, blend weights that moved and sum to 1, a model.npz that loads
   strictly, launches = (steps + validation forwards) x 58); then
   --inference --classification on that model.npz with Grad-CAM (the
   directory names' bits agree with model_probabilities.csv, launches =
   58 x (eval steps + patients)). Prints each run's seconds, the Grad-CAM
   export's seconds a patient and attention_maps' CUDA-event ms, the
   classification epochs' seconds and samples/s.
12. The CLI in bfloat16, on the CLI phase's cohort: a JSON config with
   TPU.compute_dtype bfloat16, 2 epochs (rc 0, finite losses, launches =
   supersteps x 464 + validation forwards x 58, every kernel call with
   bfloat16 x and w, the best .npz loading strictly), the export as a
   subprocess served on the card (the spec records bfloat16; a batch-3
   request answers a finite float32 (3, 2) in 58 bfloat16 launches), then
   --inference --survival with Grad-CAM on its test patients (att maps in
   [0, 1] with a max above 0.5, launches = 58 x (eval steps + 2 x
   patients)).
13. The slice's CLI paths, on the CLI phase's cohort: --images --survival
   --split with densenet201 for 2 epochs (rc 0, finite losses, launches =
   supersteps x 8 x 98 + validation forwards x 98, the best .npz loading
   strictly), its --export_path served on the card (98 launches, a finite
   (3, 2)); --images --preop --survival --blend with tinycnn for 1 epoch
   (0 launches) and its --inference with Grad-CAM (every att map in
   [0, 1]); --lr_finder --images --preop --survival with the flagship
   config (100 steps, 5,800 launches, lrs[0] = 1e-7 in float32, a finite
   min-loss rate, lr_finder.png only where matplotlib is installed).
14. Prints the kernels' JSON line, the card's line, and last
   {"ok": true, "device": {...}}.

Per-shape kernel results go to chiprun_out/chip_smoke_kernels.jsonl, the
backward's to chiprun_out/chip_smoke_backward.jsonl.
"""

from __future__ import annotations

import argparse
import copy
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and operations/s by type:
# float32 on the CUDA cores, bfloat16 dense on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
BOTTLENECK_OUT = 128  # bn_size 4 x growth 32
MEASURED_ROUNDS = 5  # timed repeats after one warm-up
SLEEP_CYCLES = 10_000_000  # ~6 ms at 1.75 GHz: longer than queuing 20 calls
# the buckets whose DenseNet121 shapes the plan sweep times (of the six;
# the kernel phase checks all six): the smallest, the training
# microbatch's and the largest, to keep the script's time in hand
SWEEP_BUCKETS = (1, 8, 32)
# how kernel_kinds sorts kernel names into kinds (first match wins)
PROFILE_KINDS = (
    ("fused_bn_relu_matmul kernel", ("fused_bn_relu_matmul",)),
    ("host<->device copies", ("Memcpy", "Memset")),
    ("cuDNN convolutions", ("xmma", "cudnn", "conv", "implicit_gemm",
                            "wgrad", "dgrad")),
    ("GEMMs", ("gemm", "cutlass", "cublas")),
    ("copies, concat", ("copy", "Cat")),
)
# the flagship superstep: A microbatches of B volumes (SUPER_BATCH_SIZE 64)
TRAIN_MICRO, TRAIN_BATCH = 8, 8
TRAIN_TIMED = 6  # timed supersteps after one warm-up
TRAIN_LR = 1e-2  # OneCycle peak over the short run
# kernel vs plain-op superstep, x max(1, |plain|) per tensor: roundoff
# alone exceeds 1e-3 (train_phase's control, the plain op with its product
# summed in another order, moves conv0's weight gradient by 4e-3 of it)
TRAIN_TOLERANCE = 1e-2
VAL_SIZE = 16  # volumes of the synthetic validation split
# augmentation on the card vs the CPU, x max(1, |cpu|): float32 einsums
# (TF32 off) and elementwise passes in another order; the sharpening
# multiplies a difference of two blurs by up to 30
AUGMENT_TOLERANCE = 1e-4
# the bfloat16 superstep's update with the kernel vs the plain op, relative
# L2: at most this many times the control's (the plain op with its product
# summed in another order), as the CPU tests hold the port against JAX
BF16_CONTROL_FACTOR = 4.0
# the CLI phase's synthetic cohort: about 67 train patients (2 supersteps
# an epoch, the second ragged), each volume MRI-like in size
CLI_PATIENTS, CLI_VOLUME, CLI_EPOCHS = 96, (80, 72, 48), 3
CLI_MODEL, CLI_SIDE, CLI_DEVICE = "densenet121", 64, "cuda"
# the wider DenseNets whose bottleneck shapes the kernel is checked at; the
# plans are swept where their K exceeds DenseNet121's largest
WIDE_MODELS = ("densenet169", "densenet201", "densenet264")
DENSENET121_MAX_K = 992
# every image model name beyond the flagship's, each driven at full width:
# an eval forward, an augmented superstep of FAMILY_MICRO x TRAIN_BATCH with
# the kernel and with the plain op, a bfloat16 eval forward
FAMILIES = ("tinycnn", "monaidensenet", "densenet169", "densenet201",
            "densenet264", "seresnet50", "r3d_18")
FAMILY_MICRO = 2
# the image-only CLI run of the widest-path slice, and the LR range test's
# default number of steps
WIDE_CLI_MODEL, WIDE_CLI_EPOCHS, LR_SWEEP_STEPS = "densenet201", 2, 100


def bound_ms(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    """Least time the card could take: each input read once, the output
    written once, the operations at the type's peak."""
    size = 4 if dtype == "float32" else 2
    moved = (m * k + k * n + m * n) * size + 2 * k * 4
    ops = 2 * m * k * n + 3 * m * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_calls(fn, iters: int = 20) -> tuple[float, float, float]:
    """Three readings of one call of ``fn``, in ms:

    device: CUDA events around ``iters`` calls enqueued behind a sleeping
        kernel, so that the host has queued them all before the first
        starts (the host's launch cost is not in it);
    host: the host's time to check and enqueue one call, from that loop;
    paced: the same events around ``iters`` back-to-back calls with no
        sleep, so that the host paces them where it is the slower side
        (how the kernel was timed before the sleep was added)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return device, host, start.elapsed_time(end) / iters


def operands(gen, m: int, k: int, dtype):
    """x, a, b, w of one (M, K) x (K, 128) bottleneck call, drawn from
    ``gen`` on the card: x normal, a in [0.5, 1.5), b normal, w at He
    scale."""
    n = BOTTLENECK_OUT
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    a = torch.rand(k, device="cuda", generator=gen) + 0.5
    b = torch.randn(k, device="cuda", generator=gen)
    w = (torch.randn(k, n, device="cuda", generator=gen)
         * (2.0 / k) ** 0.5).to(dtype)
    return x, a, b, w


def check_call(fd, x, a, b, w, tol: float, where: str):
    """The kernel against the plain version on (x, a, b, w), plus the
    properties the plain version does not show: two calls give the same
    bits, and a NaN entry of x gives a NaN output row where the plain
    version's is. Raises on a failure; returns the max abs error and the
    error relative to the largest output."""
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    again = fd.fused_bn_relu_matmul(x, a, b, w)
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    rel = diff / max(want.float().abs().max().item(), 1e-30)
    if got.dtype != x.dtype or got.shape != want.shape or not rel <= tol:
        raise AssertionError(f"kernel disagrees at {where}: max abs "
                             f"{diff:.3e}, rel {rel:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"two calls differ at {where}")
    row = min(3, x.shape[0] - 1)
    x_nan = x.clone()
    x_nan[row, 0] = float("nan")
    got_n = fd.fused_bn_relu_matmul(x_nan, a, b, w).float()
    want_n = fd.fused_bn_relu_matmul_reference(x_nan, a, b, w).float()
    nan_rows = want_n.isnan().any(1)
    ok = bool(nan_rows[row]) and torch.equal(got_n.isnan().any(1), nan_rows)
    if ok and not nan_rows.all():
        g, wn = got_n[~nan_rows], want_n[~nan_rows]
        ok = (g - wn).abs().max().item() <= tol * max(
            wn.abs().max().item(), 1e-30)
    if not ok:
        raise AssertionError(f"with a NaN in x row {row}, the kernel's NaN "
                             f"rows or other rows differ from the plain "
                             f"version's at {where}")
    return diff, rel


def kernel_phase(fd, seed: int, out_dir: Path):
    """Every (M, Cin) of DenseNet121's bottlenecks at every batch bucket of
    the servable, in float32 and bfloat16: checked (check_call) and timed
    (time_calls), with the launch plan and the bound. Returns the rows."""
    from mmnn_sts_torch.infer.export import BATCH_SIZES
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    model, n = densenet121(), BOTTLENECK_OUT
    sms = fd.sm_count(torch.cuda.current_device())
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for batch in BATCH_SIZES:
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            for block, m, k in bottleneck_shapes(model, batch):
                x, a, b, w = operands(gen, m, k, dtype)
                diff, rel = check_call(
                    fd, x, a, b, w, TOLERANCE[dtype_name],
                    f"B={batch} M={m} Cin={k} {dtype_name}")
                h = torch.relu(x.float() * a + b).to(dtype)
                bm, bn, split_k = fd.launch_plan(m, k, n, sms, dtype)
                ms, host_ms, paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul(x, a, b, w))
                plain_ms, plain_host_ms, plain_paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul_reference(x, a, b, w))
                bound, bound_by = bound_ms(m, k, n, dtype_name)
                rows.append(dict(
                    model="densenet121", batch=batch, dtype=dtype_name,
                    block=block, m=m, cin=k, cout=n, bm=bm, bn=bn,
                    split_k=split_k,
                    ctas=fd.plan_ctas(m, n, bm, bn, split_k),
                    max_abs_err=diff, max_rel_err=rel, bit_equal=True,
                    nan_rows_match=True, ms=ms, paced_ms=paced_ms,
                    host_us=host_ms * 1e3, plain_ms=plain_ms,
                    plain_paced_ms=plain_paced_ms,
                    plain_host_us=plain_host_ms * 1e3,
                    # the product alone, not the same function: a yardstick
                    gemm_ms=time_calls(lambda: torch.matmul(h, w))[0],
                    bound_ms=bound, bound_by=bound_by,
                ))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "chip_smoke_kernels.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print("kernel fused_bn_relu_matmul vs plain, per block (float32: "
          "fused_bn_relu_matmul.cu on the CUDA cores; bfloat16: "
          "fused_bn_relu_matmul_bf16.cu on the tensor cores; sums over the "
          "block's calls: device ms, calls queued behind a sleep; paced ms, "
          "no sleep; host us to enqueue; max_rel_err limit "
          f"{TOLERANCE['float32']:.0e} float32, {TOLERANCE['bfloat16']:.0e} "
          "bfloat16; every shape also bit-equal over two calls and NaN rows "
          "as the plain version's; gemm_ms: torch.matmul(h, w) on a "
          "precomputed h, the product alone, not the same function; "
          "of_bound: bound_ms / kernel_ms):")
    groups = {}
    for r in rows:
        groups.setdefault((r["batch"], r["dtype"], r["block"]), []).append(r)
    for (batch, dtype, block), rs in groups.items():
        tot = {key: sum(r[key] for r in rs) for key in (
            "ms", "paced_ms", "host_us", "plain_ms", "plain_paced_ms",
            "plain_host_us", "gemm_ms", "bound_ms")}
        print(f"  B={batch} {dtype:8s} block{block} M={rs[0]['m']:6d} "
              f"Cin={rs[0]['cin']}..{rs[-1]['cin']} n={len(rs):2d} "
              f"max_abs_err={max(r['max_abs_err'] for r in rs):.2e} "
              f"max_rel_err={max(r['max_rel_err'] for r in rs):.2e} "
              f"kernel_ms={tot['ms']:.4f} paced {tot['paced_ms']:.4f} "
              f"host_us {tot['host_us']:.1f} "
              f"plain_ms={tot['plain_ms']:.4f} paced "
              f"{tot['plain_paced_ms']:.4f} host_us "
              f"{tot['plain_host_us']:.1f} gemm_ms={tot['gemm_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} ({rs[0]['bound_by']}) "
              f"of_bound {tot['bound_ms'] / tot['ms']:.1%} "
              f"host_us/call {tot['host_us'] / len(rs):.1f}")
        print("    plan Cin:BMxBN/split(CTAs) " + " ".join(
            f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}({r['ctas']})"
            for r in rs))
    for batch in BATCH_SIZES:
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows
                  if r["batch"] == batch and r["dtype"] == dtype]
            tot = {key: sum(r[key] for r in rs) for key in (
                "ms", "paced_ms", "plain_ms", "plain_paced_ms", "gemm_ms",
                "bound_ms", "host_us")}
            print(f"  B={batch} {dtype}, {len(rs)} calls: kernel_ms "
                  f"{tot['ms']:.4f} paced {tot['paced_ms']:.4f} plain_ms "
                  f"{tot['plain_ms']:.4f} paced {tot['plain_paced_ms']:.4f} "
                  f"gemm_ms {tot['gemm_ms']:.4f} bound_ms "
                  f"{tot['bound_ms']:.4f} of_bound "
                  f"{tot['bound_ms'] / tot['ms']:.1%} host_us/call "
                  f"{tot['host_us'] / len(rs):.1f}")
    return rows


def sweep_rows(fd, gen, shapes) -> list:
    """Every launch plan each kernel takes (each tile of
    ``fd.plan_tiles(dtype)`` with every K-split ``fd.max_split`` admits) at
    each (batch, block, M, Cin) of ``shapes``, in float32 and bfloat16: each
    result held against the plain version, and its device time."""
    n, rows = BOTTLENECK_OUT, []
    sms = fd.sm_count(torch.cuda.current_device())
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for batch, block, m, k in shapes:
            x, a, b, w = operands(gen, m, k, dtype)
            want = fd.fused_bn_relu_matmul_reference(x, a, b, w).float()
            chosen = fd.launch_plan(m, k, n, sms, dtype)
            splits = range(1, fd.max_split(k, dtype) + 1)
            for plan in ((bm, bn, split) for bm, bn in fd.plan_tiles(dtype)
                         for split in splits):
                got = fd._launch(x, a, b, w, plan).float()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                if not rel <= TOLERANCE[dtype_name]:
                    raise AssertionError(
                        f"{dtype_name} plan {plan} at M={m} Cin={k}: "
                        f"rel err {rel:.2e}")
                rows.append(dict(
                    dtype=dtype_name, batch=batch, block=block, m=m,
                    cin=k, bm=plan[0], bn=plan[1], split_k=plan[2],
                    ctas=fd.plan_ctas(m, n, *plan), chosen=plan == chosen,
                    ms=time_calls(
                        lambda: fd._launch(x, a, b, w, plan))[0]))
    return rows


def print_sweep(rows, what: str):
    print(f"sweep, {what}: per dtype and block, sum of device ms over its "
          "calls with launch_plan's plans and with each shape's fastest plan "
          "(every plan checked against the plain version)")
    blocks = {}
    for r in rows:
        blocks.setdefault((r["dtype"], r["batch"], r["block"]), {}).setdefault(
            r["cin"], []).append(r)
    for (dtype, batch, block), shapes in blocks.items():
        chosen = sum(r["ms"] for rs in shapes.values() for r in rs
                     if r["chosen"])
        best = [min(rs, key=lambda r: r["ms"]) for rs in shapes.values()]
        print(f"  {dtype} B={batch} block{block}: chosen {chosen:.4f} ms, "
              f"fastest {sum(r['ms'] for r in best):.4f} ms; fastest plans "
              + " ".join(f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}"
                         f"({r['ctas']})" for r in best))


def sweep_phase(fd, seed: int, out_dir: Path):
    """sweep_rows at every (M, Cin) of DenseNet121's bottlenecks at the
    batch buckets SWEEP_BUCKETS; prints, per dtype and block, the sum of
    ``launch_plan``'s plans beside the sum of each shape's fastest plan;
    every timing goes to ``out_dir``'s plan_sweep.jsonl."""
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    model = densenet121()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = sweep_rows(fd, gen, [(batch, block, m, k)
                                for batch in SWEEP_BUCKETS
                                for block, m, k in bottleneck_shapes(model,
                                                                     batch)])
    with open(out_dir / "plan_sweep.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print_sweep(rows, f"DenseNet121's shapes at batch buckets "
                f"{SWEEP_BUCKETS}")


def wide_kernel_phase(fd, seed: int, out_dir: Path) -> dict:
    """The kernel at every bottleneck shape of the wider DenseNets
    (WIDE_MODELS) at batch TRAIN_BATCH, in float32 and bfloat16: each
    checked as kernel_phase checks its shapes (check_call), densenet264's
    130 also timed beside the plain version, cuBLAS's product alone and the
    bound. The rows go to ``out_dir``'s chip_smoke_kernels.jsonl with their
    model's name. Then every plan of both kernels at the shapes whose K
    exceeds DenseNet121's largest (blocks 3 and 4: M = 512 and 64) goes to
    plan_sweep.jsonl there. Returns densenet264's sums by dtype."""
    from mmnn_sts_torch.models import densenet

    n = BOTTLENECK_OUT
    sms = fd.sm_count(torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rows = []
    for name in WIDE_MODELS:
        with torch.device("meta"):
            shapes = densenet.bottleneck_shapes(getattr(densenet, name)(),
                                                TRAIN_BATCH)
        timed = name == WIDE_MODELS[-1]
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            for block, m, k in shapes:
                x, a, b, w = operands(gen, m, k, dtype)
                diff, rel = check_call(
                    fd, x, a, b, w, TOLERANCE[dtype_name],
                    f"{name} B={TRAIN_BATCH} M={m} Cin={k} {dtype_name}")
                row = dict(model=name, batch=TRAIN_BATCH, dtype=dtype_name,
                           block=block, m=m, cin=k, cout=n, max_abs_err=diff,
                           max_rel_err=rel, bit_equal=True,
                           nan_rows_match=True)
                if timed:
                    h = torch.relu(x.float() * a + b).to(dtype)
                    bound, bound_by = bound_ms(m, k, n, dtype_name)
                    row.update(
                        plan=fd.launch_plan(m, k, n, sms, dtype),
                        ms=time_calls(
                            lambda: fd.fused_bn_relu_matmul(x, a, b, w))[0],
                        plain_ms=time_calls(
                            lambda: fd.fused_bn_relu_matmul_reference(
                                x, a, b, w))[0],
                        gemm_ms=time_calls(lambda: torch.matmul(h, w))[0],
                        bound_ms=bound, bound_by=bound_by)
                rows.append(row)
    with open(out_dir / "chip_smoke_kernels.jsonl", "a") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"kernel at the wider DenseNets' bottleneck shapes, B={TRAIN_BATCH}"
          " (check_call: vs plain within the TOLERANCE, bit-equal twice, NaN "
          "rows as the plain version's):")
    for name in WIDE_MODELS:
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows if r["model"] == name
                  and r["dtype"] == dtype]
            print(f"  {name} {dtype}: {len(rs)} calls, Cin up to "
                  f"{max(r['cin'] for r in rs)}, max_abs_err "
                  f"{max(r['max_abs_err'] for r in rs):.2e} max_rel_err "
                  f"{max(r['max_rel_err'] for r in rs):.2e}")
    timed = {}
    for dtype in ("float32", "bfloat16"):
        rs = [r for r in rows if r["model"] == WIDE_MODELS[-1]
              and r["dtype"] == dtype]
        for blk in sorted({r["block"] for r in rs}) + [None]:
            part = [r for r in rs if blk is None or r["block"] == blk]
            tot = {key: sum(r[key] for r in part) for key in (
                "ms", "plain_ms", "gemm_ms", "bound_ms")}
            where = f"block{blk} M={part[0]['m']:6d}" if blk else "all"
            print(f"  {WIDE_MODELS[-1]} {dtype} {where} n={len(part):3d}: "
                  f"kernel_ms {tot['ms']:.4f} plain_ms {tot['plain_ms']:.4f} "
                  f"gemm_ms {tot['gemm_ms']:.4f} bound_ms "
                  f"{tot['bound_ms']:.4f} of_bound "
                  f"{tot['bound_ms'] / tot['ms']:.1%}")
        timed[dtype] = dict(tot, calls=len(rs), bound_by=max(
            ("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)))

    wide = sorted({(TRAIN_BATCH, r["block"], r["m"], r["cin"]) for r in rows
                   if r["block"] >= 3 and r["cin"] > DENSENET121_MAX_K})
    sweep = sweep_rows(fd, gen, wide)
    with open(out_dir / "plan_sweep.jsonl", "a") as f:
        f.writelines(json.dumps(dict(r, wide=True)) + "\n" for r in sweep)
    print_sweep(sweep, f"the wider DenseNets' {len(wide)} shapes with K "
                f"beyond DenseNet121's {DENSENET121_MAX_K}")
    return timed


def random_flat_weights(model, seed: int, to_jax_flat) -> dict:
    """Weights for every parameter of ``model``, drawn with numpy, in the
    JAX package's flat key layout with the unfused bottleneck names."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, v in to_jax_flat(model.state_dict(), layout="unfused").items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":  # conv (k,k,k,I,O) or dense (I,O): fan-in scale
            fan_in = int(np.prod(v.shape[:-1]))
            gain = 2.0 if v.ndim == 5 else 1.0
            v = rng.normal(0.0, (gain / fan_in) ** 0.5, v.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif leaf in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        flat[key] = np.asarray(v, np.float32)
    return flat


def post_npz(port: int, arrays: dict) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/invocations", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"/invocations answered {r.status}")
        with np.load(io.BytesIO(r.read())) as data:
            return np.asarray(data["predictions"])


def serve_phase(fd, seed: int, workdir: Path):
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import (
        ServingModel, export_forward, model_spec)
    from mmnn_sts_torch.infer.server import ModelServer
    from mmnn_sts_torch.models import build_model

    cfg = Config()  # densenet121, 64^3 x 2ch, 12 features, 2 classes, 11 preop
    flags = dict(images=True, preop=True, postop=False, blend=True)
    model = build_model(cfg, **flags)
    load_jax_npz(model, random_flat_weights(model, seed, to_jax_flat))
    artifact = str(workdir / "model.pt")
    spec = model_spec(cfg, **flags)
    export_forward(model, spec, artifact)

    rng = np.random.default_rng(seed + 1)
    image = tuple(cfg.image_model.spatial_size) + (cfg.image_model.in_channels,)
    requests = {
        b: {"image": (rng.normal(size=(b,) + image) ** 2 * 500
                      ).astype(np.float32),
            "clinical": rng.normal(size=(b, spec["num_tabular_inputs"])
                                   ).astype(np.float32)}
        for b in (1, 3, 8)
    }
    srv = ModelServer(artifact, host="127.0.0.1", port=0, device="cuda")
    srv.start_background()
    answers, latencies = {}, {b: [] for b in requests}
    try:
        fd.fused_bn_relu_matmul.launches = 0
        for _ in range(1 + MEASURED_ROUNDS):  # the first round warms up
            for b, arrays in requests.items():
                before = fd.fused_bn_relu_matmul.launches
                t0 = time.perf_counter()
                preds = post_npz(srv.port, arrays)
                latencies[b].append((time.perf_counter() - t0) * 1e3)
                launched = fd.fused_bn_relu_matmul.launches - before
                if launched != 58:
                    raise AssertionError(
                        f"a served B={b} forward launched the kernel "
                        f"{launched} times, not 58")
                if preds.shape != (b, 2) or not np.all(np.isfinite(preds)):
                    raise AssertionError(
                        f"bad answer for B={b}: shape {preds.shape}, "
                        f"finite={np.isfinite(preds).all()}")
                answers[b] = preds
        launches = fd.fused_bn_relu_matmul.launches
    finally:
        srv.shutdown()
    for b, ms in latencies.items():
        print(f"serve request B={b} (bucket {srv.model._bucket(b)}): first "
              f"{ms[0]:.1f} ms, then median {np.median(ms[1:]):.1f} ms, max "
              f"{max(ms[1:]):.1f} ms of {MEASURED_ROUNDS} (host clock, npz "
              "over HTTP on localhost)")

    # the same servable with the plain op in place of the kernel
    with mock.patch.object(fd, "fused_bn_relu_matmul",
                           fd.fused_bn_relu_matmul_reference):
        plain = ServingModel(artifact, device="cuda")
        for b, arrays in requests.items():
            want = plain(arrays)
            diff = float(np.abs(answers[b] - want).max())
            limit = 1e-3 * max(1.0, float(np.abs(want).max()))
            print(f"serve B={b}: kernel vs plain op max|diff| {diff:.3e} "
                  f"(limit {limit:.1e})")
            if not diff <= limit:
                raise AssertionError(f"served B={b} disagrees with the plain op")
    want = ServingModel(artifact, device="cpu")(requests[1])
    diff = float(np.abs(answers[1] - want).max())
    limit = 1e-2 * max(1.0, float(np.abs(want).max()))
    print(f"serve B=1: card vs CPU max|diff| {diff:.3e} (limit {limit:.1e}); "
          f"answer {answers[1].tolist()}")
    if not diff <= limit:
        raise AssertionError("served B=1 disagrees with the CPU forward")
    time_payload(requests[8])
    profile_forward(ServingModel(artifact, device="cuda"), requests[8])
    return launches


def time_payload(arrays):
    """Host time of the request body's npz encoding (the client's side) and
    of the server's decoding of it, outside HTTP."""
    from mmnn_sts_torch.infer.server import NPZ, _decode_request

    enc, dec = [], []
    for _ in range(MEASURED_ROUNDS):
        t0 = time.perf_counter()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
        t1 = time.perf_counter()
        _decode_request(body, NPZ)
        enc.append((t1 - t0) * 1e3)
        dec.append((time.perf_counter() - t1) * 1e3)
    print(f"payload B={len(arrays['image'])}: {len(body) / 1e6:.1f} MB npz, "
          f"encode median {np.median(enc):.2f} ms, decode median "
          f"{np.median(dec):.2f} ms of {MEASURED_ROUNDS} (host clock)")


def profile_forward(model, arrays, top: int = 12):
    """Where one served forward's time goes (a ServingModel call, without
    HTTP): its wall time without the profiler, and torch.profiler's CUDA
    kernel times by name. One stream, so the kernels do not overlap and
    their sum over the wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(1 + MEASURED_ROUNDS):
        t0 = time.perf_counter()
        model(arrays)  # ends in a device -> host copy of the answer
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls[1:]))
    print_host_calls(model, arrays, wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(arrays)
    kernel_kinds(prof, wall, f"served forward B="
                 f"{len(next(iter(arrays.values())))}, wall median of "
                 f"{MEASURED_ROUNDS} (no profiler)", top)


def kernel_kinds(prof, wall: float, what: str, top: int = 12) -> dict:
    """Print a torch.profiler trace's CUDA kernel time against ``wall`` ms
    (one stream, so kernels do not overlap and their sum over the wall is
    the device's busy share), by kind (PROFILE_KINDS) and for the ``top``
    kernels. Returns kind -> ms, with the total under "busy". Ranges that
    the trace also keeps on the device's timeline (user annotations, such
    as the optimizer's step) are not kernels and are left out."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profile {what}: wall {wall:.2f} ms; CUDA kernels {busy:.2f} ms "
          f"in {sum(e.count for e in kernels)} launches = device busy "
          f"{busy / wall:.1%}")
    kinds = {}
    for e in kernels:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other PyTorch kernels")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + e.device_time_total / 1e3, n + e.count)
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms {n:6d}x [{kind}]")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:110]}")
    return {"busy": busy, **{k: ms for k, (ms, _) in kinds.items()}}


def print_host_calls(model, arrays, wall: float):
    """Host time of the fused op's calls in one served forward (a
    ServingModel call): each call of the wrapper
    ``fused_dense.fused_bn_relu_matmul`` (checks, plan, ctypes launch) and
    of the op ``densenet.bn_relu_conv1x1`` (the BN fold, then the wrapper)
    timed on the host clock. Nothing waits for the device there, so this
    is the time to check and enqueue, against the forward's ``wall`` ms."""
    from mmnn_sts_torch.models import densenet
    from mmnn_sts_torch.ops import fused_dense

    spent = {}

    def timed(module, name):
        orig = getattr(module, name)
        spent[name] = []

        @functools.wraps(orig)  # carries a wrapper's launch count along
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                spent[name].append(time.perf_counter() - t0)

        return mock.patch.object(module, name, call)

    with timed(fused_dense, "fused_bn_relu_matmul"), \
            timed(densenet, "bn_relu_conv1x1"):
        model(arrays)
    for name, ts in spent.items():
        print(f"host time in the served forward: {name} {len(ts)} calls, "
              f"mean {np.mean(ts) * 1e6:.1f} us, sum {sum(ts) * 1e3:.3f} ms "
              f"({sum(ts) * 1e3 / wall:.1%} of the {wall:.2f} ms wall)")


def backward_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time of the float32 backward: x, g, w, a, b read once, dx, da,
    db, dw written once; the two products (4 M K N) and about 8 M K
    elementwise operations at the float32 peak."""
    moved = (2 * m * k + m * n + 2 * k * n + 4 * k) * 4
    ops = 4 * m * k * n + 8 * m * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nan_aware_rel_err(got, want, where: str) -> float:
    """The largest |got - want| over the finite entries, relative to the
    largest finite |want|; raises unless NaN sits at the same places."""
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"NaN entries differ at {where}")
    fin = ~want.isnan()
    if not fin.any():
        return 0.0
    scale = max(want[fin].abs().max().item(), 1e-30)
    return (got[fin] - want[fin]).abs().max().item() / scale


def backward_phase(fd, seed: int, out_dir: Path):
    """The fused op under autograd at DenseNet121's 58 bottleneck shapes at
    microbatch 8 in float32, a NaN in one row of x: the Function's dx, da,
    db and dw (kernel forward, then fused_bn_relu_matmul_backward) against
    torch autograd through the plain version (TOLERANCE, relative to the
    largest finite entry). Times the backward, the plain version's
    backward and the two products alone (device ms, time_calls). Returns
    the rows."""
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    n, tol = BOTTLENECK_OUT, TOLERANCE["float32"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = []
    for block, m, k in bottleneck_shapes(densenet121(), TRAIN_BATCH):
        x, a, b, w = operands(gen, m, k, torch.float32)
        x[min(3, m - 1), 0] = float("nan")
        g = torch.randn(m, n, device="cuda", generator=gen)
        leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
        fd.FusedBnReluMatmul.apply(*leaves).backward(g)
        plain = [t.clone().requires_grad_() for t in (x, a, b, w)]
        out = fd.fused_bn_relu_matmul_reference(*plain)
        out.backward(g, retain_graph=True)
        torch.cuda.synchronize()
        errs = {name: nan_aware_rel_err(t.grad, p.grad, f"{name} M={m} "
                                        f"Cin={k}")
                for name, t, p in zip(("dx", "da", "db", "dw"), leaves, plain)}
        if not max(errs.values()) <= tol:
            raise AssertionError(f"backward disagrees at M={m} Cin={k}: "
                                 f"{errs}")
        bound, bound_by = backward_bound_ms(m, k, n)
        rows.append(dict(
            block=block, m=m, cin=k, max_rel_err=max(errs.values()),
            ms=time_calls(lambda: fd.fused_bn_relu_matmul_backward(
                x, a, b, w, g))[0],
            plain_ms=time_calls(lambda: torch.autograd.grad(
                out, plain, g, retain_graph=True))[0],
            mm_ms=time_calls(lambda: (torch.matmul(g, w.T),
                                      torch.matmul(x.T, g)))[0],
            bound_ms=bound, bound_by=bound_by))
    with open(out_dir / "chip_smoke_backward.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"backward of the fused op (kernel forward + _bwd) vs autograd of "
          f"the plain version, B={TRAIN_BATCH} float32, a NaN row per shape, "
          f"max_rel_err limit {tol:.0e}; device ms summed per block (mm_ms: "
          "the two products alone):")
    for blk in sorted({r["block"] for r in rows}):
        rs = [r for r in rows if r["block"] == blk]
        print(f"  block{blk} M={rs[0]['m']:6d} n={len(rs):2d} max_rel_err="
              f"{max(r['max_rel_err'] for r in rs):.2e} " + " ".join(
                  f"{key}={sum(r[key] for r in rs):.4f}"
                  for key in ("ms", "plain_ms", "mm_ms", "bound_ms")))
    print(f"  {len(rows)} calls: " + " ".join(
        f"{key}={sum(r[key] for r in rows):.4f}"
        for key in ("ms", "plain_ms", "mm_ms", "bound_ms")))
    return rows


def synthetic_split(rng, lead: tuple, spec: dict, device):
    """MRI-like volumes (squared normals x 500), clinical rows, events and
    integer durations in 1..24 (many ties), with leading shape ``lead``."""
    image = tuple(spec["image_model"]["spatial_size"]) \
        + (spec["image_model"]["in_channels"],)
    inputs = {
        "image": torch.from_numpy((rng.normal(size=lead + image) ** 2 * 500
                                   ).astype(np.float32)).to(device),
        "clinical": torch.from_numpy(rng.normal(
            size=lead + (spec["num_tabular_inputs"],)).astype(np.float32)
        ).to(device)}
    events = torch.from_numpy(
        (rng.random(lead + (2,)) < 0.7).astype(np.float32)).to(device)
    durations = torch.from_numpy(
        rng.integers(1, 25, lead + (2,)).astype(np.float32)).to(device)
    return inputs, events, durations


def reassociated_reference(x, a, b, w):
    """The plain version with its product summed as two halves of K, in
    float32, rounded once to x's dtype: the same function, its sums in
    another order (a control for how far roundoff alone moves a
    superstep)."""
    from mmnn_sts_torch.ops.fused_dense import fused_bn_relu_matmul_reference

    k = x.shape[1] // 2
    return (fused_bn_relu_matmul_reference(x[:, :k].float(), a[:k], b[:k],
                                           w[:k])
            + fused_bn_relu_matmul_reference(x[:, k:].float(), a[k:], b[k:],
                                             w[k:])).to(x.dtype)


def train_phase(fd, seed: int):
    """The flagship survival superstep on the card (see the module
    docstring, phase 6). Returns the kernel's launches in one superstep."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.models.common import Dropout
    from mmnn_sts_torch.ops.blending import blend_update, surv_head_losses
    from mmnn_sts_torch.ops.metrics import c_indices_per_class
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.ops import augment
    from mmnn_sts_torch.train import steps
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import (
        survival_eval_step, survival_train_superstep)
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()  # densenet121, 64^3 x 2ch, dropout 0.2, 11 preop
    flags = dict(images=True, preop=True, postop=False, blend=True)
    spec = model_spec(cfg, **flags)
    weights = random_flat_weights(build_model(cfg, **flags), seed,
                                  to_jax_flat)

    def new_state(dropout: bool, total_steps: int):
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        if not dropout:
            for mod in model.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
        model.cuda()
        return create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, total_steps, 1), seed=seed)

    def superstep(state, mask=None):
        return survival_train_superstep(
            state, inputs, events, durations, blend=True, augment=False,
            mask=mask)

    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, "cuda")
    vals = synthetic_split(rng, (VAL_SIZE,), spec, "cuda")
    volumes = TRAIN_MICRO * TRAIN_BATCH

    # the kernel against the plain op, one superstep each from one state
    torch.backends.cudnn.allow_tf32 = False
    print(f"train: {TRAIN_MICRO} x {TRAIN_BATCH} volumes of "
          f"{tuple(inputs['image'].shape[2:])} float32 per superstep; "
          f"kernel vs plain op with cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, dropout 0")

    def run_with(op):
        """A superstep from the initial state with ``op`` in place of the
        kernel's wrapper: its superstep_tensors."""
        state = new_state(False, 4)
        with mock.patch.object(fd, "fused_bn_relu_matmul", op):
            return superstep_tensors(superstep(state), state.model)

    kernel_state = new_state(False, 4)
    fd.fused_bn_relu_matmul.launches = 0
    got = superstep(kernel_state)
    torch.cuda.synchronize()
    launched = fd.fused_bn_relu_matmul.launches
    if launched != 58 * TRAIN_MICRO:
        raise AssertionError(f"a superstep launched the kernel {launched} "
                             f"times, not {58 * TRAIN_MICRO}")
    want = run_with(fd.fused_bn_relu_matmul_reference)
    kernel_dev = deviations(superstep_tensors(got, kernel_state.model), want)
    bad = [(r, n) for r, n in kernel_dev if not r <= 1.0]
    if bad:
        raise AssertionError(f"superstep, kernel vs plain op beyond "
                             f"{TRAIN_TOLERANCE:.0e} x max(1, |plain|): {bad}")
    # the control: the plain op with its product summed in another order
    control_dev = deviations(run_with(reassociated_reference), want)
    print(f"train superstep: {launched} kernel launches; loss kernel "
          f"{got['loss'].item():.6f} plain {want['loss'].item():.6f}; preds "
          f"{tuple(got['preds'].shape)}; loss, preds and "
          f"{len(kernel_dev) - 2} summed gradients and running statistics "
          f"within {TRAIN_TOLERANCE:.0e}"
          f" x max(1, |plain|): largest {max(kernel_dev)[0]:.1%} of it "
          f"({max(kernel_dev)[1]}); the plain op with its product summed in "
          f"two halves of K, against the plain op: largest "
          f"{max(control_dev)[0]:.1%} ({max(control_dev)[1]})")
    del want

    mask = torch.ones(TRAIN_MICRO, TRAIN_BATCH, device="cuda")
    mask[-1, TRAIN_BATCH // 2:] = 0  # a ragged tail: 60 of 64 valid
    masked = superstep(kernel_state, mask)
    grads = [p.grad for p in kernel_state.model.parameters()]
    if not (torch.isfinite(masked["loss"]) and all(
            torch.isfinite(g).all() for g in grads)):
        raise AssertionError("the masked superstep's loss or gradients are "
                             "not finite")
    print(f"train masked superstep ({int(mask.sum())} of {volumes} valid): "
          f"loss {masked['loss'].item():.6f}, all gradients finite")
    del kernel_state, got, masked, grads

    # a short run as configured: TF32 convolutions, dropout 0.2
    torch.backends.cudnn.allow_tf32 = True
    state = new_state(True, 2 + TRAIN_TIMED)
    print(f"train run: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"dropout {cfg.image_model.dropout_prob}, OneCycle peak "
          f"{TRAIN_LR} over {2 + TRAIN_TIMED} steps")
    val_before = survival_eval_step(state, *vals, blend=True)
    rewind = state.generator.get_state()
    out = {}

    def step_and_keep():
        out["last"] = superstep(state)
        out.setdefault("first", out["last"])
        return out["last"]

    # the last timed superstep draws the warm-up's dropout masks
    ms = timed_supersteps(step_and_keep, volumes, "train superstep",
                          before_last=lambda: state.generator.set_state(
                              rewind))
    first, last = out["first"], out["last"]
    loss0, loss1 = first["loss"].item(), last["loss"].item()
    print(f"train loss on the fixed batch, same dropout masks: first "
          f"superstep {loss0:.6f}, last {loss1:.6f}")
    if not loss1 < loss0:
        raise AssertionError("the loss on the fixed batch did not fall")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        superstep(state)
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof, float(np.median(ms)),
                         "train superstep, wall the timed median", top=15)
    bwd, bwd_mm, bwd_calls = 0.0, 0.0, 0
    for e in prof.events():  # the Function's backward nodes and their mms
        if e.name == "FusedBnReluMatmulBackward":
            bwd_calls += 1
            bwd += e.device_time_total / 1e3
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.name == "aten::mm":
                    bwd_mm += c.device_time_total / 1e3
                else:
                    stack.extend(c.cpu_children)
    if bwd_calls != launched:
        raise AssertionError(f"the trace holds {bwd_calls} backward calls of "
                             f"the fused op, not {launched}")
    busy = kinds["busy"]
    fused = kinds.get("fused_bn_relu_matmul kernel", 0.0)
    print(f"train superstep device time: fused kernel {fused:.3f} ms "
          f"({fused / busy:.1%}); the fused op's backward {bwd:.3f} ms "
          f"({bwd / busy:.1%}): its two products {bwd_mm:.3f} ms, its "
          f"elementwise and column-sum pass {bwd - bwd_mm:.3f} ms "
          f"({(bwd - bwd_mm) / busy:.1%})")

    val_after = survival_eval_step(state, *vals, blend=True)
    c_index = c_indices_per_class(val_after["preds"][0].cpu().numpy(),
                                  vals[1].cpu().numpy(), vals[2].cpu().numpy())

    def train_head_losses(aux):
        return sum(surv_head_losses(aux["preds"][i], events[i], durations[i])
                   for i in range(TRAIN_MICRO))

    blend = blend_update(state.blend, train_head_losses(first),
                         surv_head_losses(val_before["preds"], *vals[1:]),
                         survival=True)
    blend = blend_update(blend, train_head_losses(last),
                         surv_head_losses(val_after["preds"], *vals[1:]),
                         survival=True)
    total = blend.weights.sum().item()
    if not (abs(total - 1.0) <= 1e-5 and torch.isfinite(blend.weights).all()
            and all(0.0 <= c <= 1.0 for c in c_index)):
        raise AssertionError(f"blend weights {blend.weights.tolist()} or "
                             f"C-indices {c_index} out of range")
    state.blend = blend
    print(f"train validation ({VAL_SIZE} volumes): loss "
          f"{val_after['loss'].item():.6f}, selection loss "
          f"{val_after['selection_loss'].item():.6f}, C-indices {c_index}; "
          f"blend weights after two updates {blend.weights.tolist()} "
          f"(sum {total:.6f})")

    # the superstep as the run trains it: the random augmentation on
    def augmented():
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=True)
        if not torch.isfinite(aux["loss"]):
            raise AssertionError("an augmented superstep's loss is not finite")
        return aux

    # the deterministic transform on the card against the same on the CPU,
    # from one microbatch's draws
    params = augment.draw_augment_params(
        TRAIN_BATCH, state.generator, "cuda", tuple(inputs["image"].shape[2:]))
    on_card = augment.apply_train_augment(inputs["image"][0], params)
    on_cpu = augment.apply_train_augment(
        inputs["image"][0].cpu(), {k: v.cpu() for k, v in params.items()})
    diff = (on_card.cpu() - on_cpu).abs().max().item()
    print(f"train augmentation, microbatch of {TRAIN_BATCH}: card vs CPU "
          f"max|diff| {diff:.3e} (limit {AUGMENT_TOLERANCE:.0e} x max(1, "
          f"|cpu|) = {AUGMENT_TOLERANCE * max(1.0, on_cpu.abs().max().item()):.1e})")
    if not diff <= AUGMENT_TOLERANCE * max(1.0, on_cpu.abs().max().item()):
        raise AssertionError("the augmentation on the card disagrees with "
                             "the CPU")
    aug_ms = timed_supersteps(augmented, volumes,
                              "train superstep with augmentation")
    ranged = profiler_range(steps.train_augment_batch, "train_augment")
    with mock.patch.object(steps, "train_augment_batch", ranged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        augmented()
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof, float(np.median(aug_ms)),
                         "augmented train superstep, wall the timed median",
                         top=8)
    aug_dev, aug_launches, aug_calls = range_totals(prof, "train_augment")
    if aug_calls != TRAIN_MICRO:
        raise AssertionError(f"the trace holds {aug_calls} augmentation "
                             f"calls, not {TRAIN_MICRO}")
    print(f"train augmentation in one superstep: {aug_calls} calls (one a "
          f"microbatch of {TRAIN_BATCH}), {aug_launches} kernel launches, "
          f"{aug_dev:.3f} ms device time ({aug_dev / kinds['busy']:.1%} of "
          f"the superstep's kernels)")
    return launched


def timed_supersteps(step, volumes: int, what: str, before_last=None):
    """A warm-up call of ``step`` and TRAIN_TIMED timed ones (CUDA events
    around each); prints volumes/s (median, min, max), the host wall and
    the peak memory, and returns the timed ms. ``before_last`` runs just
    before the last timed call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()  # warm-up
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        if i == TRAIN_TIMED - 1 and before_last is not None:
            before_last()
        starts[i].record()
        step()
        ends[i].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    ms = np.array([s.elapsed_time(e) for s, e in zip(starts, ends)])
    rate = volumes * 1e3 / ms
    peak = torch.cuda.max_memory_allocated()
    print(f"{what} timing ({TRAIN_TIMED} after a warm-up, CUDA "
          f"events): median {np.median(ms):.1f} ms (min {ms.min():.1f}, max "
          f"{ms.max():.1f}; host wall {wall:.1f} ms a superstep) = "
          f"{np.median(rate):.1f} volumes/s (min {rate.min():.1f}, max "
          f"{rate.max():.1f}); max_memory_allocated {peak / 2**30:.2f} GiB")
    return ms


def profiler_range(fn, name: str):
    """``fn`` with each call inside a torch.profiler range ``name``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return call


def range_totals(prof, name: str) -> tuple[float, int, int]:
    """(device ms, kernel launches, calls) of the profiler ranges ``name``
    in a trace, their child ops' kernels included."""
    ms, launches, calls = 0.0, 0, 0
    for e in prof.events():
        if e.name != name or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        calls += 1
        ms += e.device_time_total / 1e3
        stack = [e]
        while stack:
            c = stack.pop()
            launches += len(c.kernels)
            stack.extend(c.cpu_children)
    return ms, launches, calls


# the clinical CSV's columns, as the cohort's export names them
CLINICAL_COLUMNS = (
    "MRN", "Sex", "Age", "Location3", "Diagnosis", "Chemo (Neoadjuvant)",
    "TumorSize", "TumorVolume (cm^3)",
    "TumorDepth (1 = deep to fascia, 0 = superficial) ", "TumorGrade",
    "Metsatpresentation", "RT Type (0 = preop, 1 = postop",
    "Margin (negative==0, microscopically positive==1, grossly positive==2)",
    "Necrosis % (information not known prior to operation)", "LengthOR",
    "VitalStatus", "Distant metastasis", "FUtime", "Date of Distant Mets",
    "Surgery_Date")


def write_cohort(root: Path, n: int, seed: int) -> dict:
    """A synthetic cohort on disk without pandas: clinical.csv (survival
    times drawn from a hazard of grade, volume and age; ISO dates, string
    categoricals, '%' necrosis with gaps), key.csv ('Anon MRN' -> MRN) and
    t1/ t2/ trees of one folder per patient with scan_*.nii.gz and
    mask_*.nii.gz (CLI_VOLUME voxels, squared normals x 500, the mask a box
    inside)."""
    import csv
    import datetime

    from mmnn_sts_torch.data.nifti import save_nifti

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    uids = 1000 + np.arange(n)
    grade = rng.integers(1, 4, n)
    volume = rng.uniform(10, 2000, n).round(1)
    age = rng.integers(20, 90, n)
    risk = (0.8 * (grade - 2) + 1.2 * (np.log(volume) - np.log(300))
            + 0.02 * (age - 55))
    t_event = rng.exponential(scale=900 * np.exp(-risk))
    futime = np.minimum(t_event, rng.uniform(500, 3000, n)).astype(int) + 1
    vital = (t_event <= futime).astype(int)
    dm = rng.random(n) < 1 / (1 + np.exp(-risk))
    met_days = np.maximum((t_event * rng.uniform(0.3, 0.9, n)).astype(int), 10)
    surgery = datetime.date(2015, 1, 1)
    columns = [
        uids, rng.choice(["M", "F"], n), age,
        rng.choice(["Thigh", "Pelvis", "Arm"], n),
        rng.choice(["MFH", "Liposarcoma", "Synovial"], n),
        rng.choice(["Yes", "No"], n), rng.uniform(1, 25, n).round(1), volume,
        rng.integers(0, 2, n), grade, rng.integers(0, 2, n),
        rng.integers(0, 2, n), rng.integers(0, 3, n),
        [f"{v}%" if keep else "" for v, keep in
         zip(rng.integers(0, 100, n), rng.random(n) < 0.8)],
        rng.integers(60, 400, n), vital, dm.astype(int), futime,
        [(surgery + datetime.timedelta(days=int(d))).isoformat() if e else ""
         for d, e in zip(met_days, dm)],
        [surgery.isoformat()] * n]
    paths = {"clinical": root / "clinical.csv", "key": root / "key.csv",
             "root": root}
    with open(paths["clinical"], "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(CLINICAL_COLUMNS)
        out.writerows(zip(*columns))
    anon = [f"STS-{i:03d}" for i in range(n)]
    with open(paths["key"], "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Anon MRN", "MRN"])
        out.writerows(zip(anon, uids))
    mask = np.zeros(CLI_VOLUME, np.float32)
    mask[8:-8, 8:-8, 6:-6] = 1.0
    for modality in ("t1", "t2"):
        for a in anon:
            pdir = root / modality / a
            pdir.mkdir(parents=True)
            image = (rng.normal(size=CLI_VOLUME) ** 2 * 500).astype(np.float32)
            save_nifti(str(pdir / f"scan_{a}.nii.gz"), image)
            save_nifti(str(pdir / f"mask_{a}.nii.gz"), mask)
    return paths


def counted(fn, counts: dict, name: str):
    """``fn``, adding one to ``counts[name]`` and the host seconds of each
    call to ``counts[name + '_s']``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            counts[name] = counts.get(name, 0) + 1
            counts.setdefault(name + "_s", []).append(
                time.perf_counter() - t0)

    return call


def cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The survival run through the port's CLI at full width (see the
    module docstring, phase 10). Returns its kernel launches and counts."""
    from mmnn_sts_torch import cli, pipeline
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop
    from mmnn_sts_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    paths = write_cohort(workdir / "cohort", CLI_PATIENTS, seed + 4)
    print(f"cli cohort written (csv + save_nifti, {CLI_PATIENTS} patients, "
          f"T1/T2 {CLI_VOLUME}): {time.perf_counter() - t0:.1f} s")
    config = {"Data": {"data_loc": str(paths["clinical"]),
                       "image_loc": str(paths["root"]),
                       "key_loc": str(paths["key"])},
              "ImageModel": {"name": CLI_MODEL, "modality": "t1t2",
                             "in_channels": 2,
                             "spatial_size": [CLI_SIDE] * 3},
              "Hyperparameters": {"train_batch_size": TRAIN_BATCH,
                                  "seed": seed}}
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(config))
    run_dir, out, ck = workdir / "run", workdir / "run" / "out", \
        workdir / "run" / "ck"
    run_dir.mkdir()
    args = ["--images", "--preop", "--survival", "--blend", "--split",
            "--config", str(config_path), "--blend_update_interval", "1",
            "--output_path", str(out), "--checkpoint_dir", str(ck),
            "--device", CLI_DEVICE]

    counts = {}
    patches = [
        mock.patch.object(pipeline, "load_cohort",
                          counted(pipeline.load_cohort, counts, "cohort")),
        mock.patch.object(loop, "survival_train_superstep",
                          counted(loop.survival_train_superstep, counts,
                                  "supersteps")),
        mock.patch.object(evaluate, "survival_eval_step",
                          counted(evaluate.survival_eval_step, counts,
                                  "val_forwards")),
        mock.patch.object(checkpoint.AsyncNpzSaver, "submit",
                          counted(checkpoint.AsyncNpzSaver.submit, counts,
                                  "best_saves")),
        mock.patch.object(checkpoint.CheckpointManager, "save",
                          counted(checkpoint.CheckpointManager.save, counts,
                                  "checkpoints")),
    ]

    def run(extra):
        cwd = Path.cwd()
        os.chdir(run_dir)  # --split writes the uid files here
        try:
            for p in patches:
                p.start()
            return cli.main(args + extra)
        finally:
            for p in patches:
                p.stop()
            os.chdir(cwd)

    fd.fused_bn_relu_matmul.launches = 0
    t0 = time.perf_counter()
    rc = run(["--epochs", str(CLI_EPOCHS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.fused_bn_relu_matmul.launches
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    uid_lists = {name: (run_dir / f"{name}_uids.txt").read_text().split()
                 for name in ("train", "val", "test")}
    if sum(len(v) for v in uid_lists.values()) != CLI_PATIENTS:
        raise AssertionError(f"uid files {uid_lists}")
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    if [r["epoch"] for r in rows] != list(range(1, CLI_EPOCHS + 1)) or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all()
            and 0.0 <= r["train_c"] <= 1.0 and 0.0 <= r["val_c"] <= 1.0
            for r in rows):
        raise AssertionError(f"metrics rows {rows}")
    blend = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if not (blend.shape == (CLI_EPOCHS + 1, 3)
            and np.allclose(blend.sum(1), 1.0, atol=1e-5)
            and not np.allclose(blend[-1], blend[0])):
        raise AssertionError(f"blend history {blend.tolist()}")
    fresh = build_model(parse_config(str(config_path)), True, True, False,
                        True)
    checkpoint.load_params_npz(str(out / "best_surv_model.npz"), fresh)
    per_forward = sum(fresh.image_model.block_config)  # 58 in DenseNet121
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if launches != expected:
        raise AssertionError(
            f"the CLI run launched the kernel {launches} times, not "
            f"{counts['supersteps']} supersteps x {per_forward * TRAIN_MICRO}"
            f" + {counts['val_forwards']} validation forwards x "
            f"{per_forward} = {expected}")
    spe = counts["supersteps"] // CLI_EPOCHS
    run_counts = {"launches": launches, "per_epoch": launches // CLI_EPOCHS,
                  "supersteps": counts["supersteps"],
                  "val_forwards": counts["val_forwards"]}
    print(f"cli run: rc {rc}, {wall:.1f} s; train/val/test "
          f"{len(uid_lists['train'])}/{len(uid_lists['val'])}/"
          f"{len(uid_lists['test'])} patients; cohort build (load_cohort) "
          f"{counts['cohort_s'][0]:.1f} s; {counts['supersteps']} supersteps "
          f"({spe} an epoch), {counts['val_forwards']} validation forwards; "
          f"kernel launches {launches} = {expected} expected "
          f"({launches // CLI_EPOCHS} an epoch)")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock; samples "
              f"include the wrap pad), train loss {r['train_loss']:.4f}, "
              f"val loss {r['val_loss']:.4f}, train C {r['train_c']:.3f}, "
              f"val C {r['val_c']:.3f}")
    epoch_s = sum(r["epoch_seconds"] for r in rows)
    parts = {name: sum(counts[name + "_s"]) for name in (
        "supersteps", "val_forwards", "checkpoints")}
    print(f"  host seconds over the {CLI_EPOCHS} epochs, of the run's "
          f"{wall:.1f} s: the epochs' training ({epoch_s:.2f} s, the "
          f"epoch_seconds of metrics.jsonl) with the supersteps' calls "
          f"{parts['supersteps']:.2f} s (the host sets the pace, so a call "
          f"returns about when its work is done); after it, validation "
          f"forwards {parts['val_forwards']:.2f} s and checkpoints "
          f"{parts['checkpoints']:.2f} s")
    print(f"  best saves {counts.get('best_saves', 0)}, host stall of each "
          f"(snapshot + queue): " + ", ".join(
              f"{t * 1e3:.2f} ms" for t in counts.get("best_saves_s", [])))
    print(f"  blend weights {blend[-1].tolist()}; artifacts "
          f"{sorted(os.listdir(out))}; checkpoints "
          f"{sorted(os.listdir(ck))}")

    step_before = torch.load(ck / f"ckpt_{CLI_EPOCHS:08d}.pt",
                             weights_only=True)["step"]
    rc = run(["--epochs", str(CLI_EPOCHS + 1), "--resume"])
    manager = CheckpointManager(str(ck))
    step_after = torch.load(ck / f"ckpt_{CLI_EPOCHS + 1:08d}.pt",
                            weights_only=True)["step"]
    # the resumed run rewrites the blend history whole
    resumed = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if rc != 0 or manager.latest_step() != CLI_EPOCHS + 1 \
            or step_after != step_before + spe \
            or resumed.shape != (CLI_EPOCHS + 2, 3) \
            or not np.array_equal(resumed[:-1], blend):
        raise AssertionError(f"resume: rc {rc}, latest checkpoint "
                             f"{manager.latest_step()}, step {step_before} "
                             f"-> {step_after}, blend history "
                             f"{resumed.tolist()}")
    print(f"cli --resume: epoch {CLI_EPOCHS + 1} ran, step {step_before} -> "
          f"{step_after}; blend history {len(resumed)} rows")

    config["Hyperparameters"]["model_weights"] = str(
        out / "best_surv_model.npz")
    trained = workdir / "trained.json"
    trained.write_text(json.dumps(config))
    artifact = workdir / "model.pt"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mmnn_sts_torch", "--images", "--preop",
         "--survival", "--blend", "--split", "--config", str(trained),
         "--output_path", str(out), "--export_path", str(artifact),
         "--device", CLI_DEVICE],
        cwd=run_dir, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"python3 -m mmnn_sts_torch --export_path "
                             f"failed: {res.stderr[-3000:]}")
    rng = np.random.default_rng(seed + 5)
    answer = ServingModel(str(artifact), device=CLI_DEVICE)({
        "image": (rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2 * 500
                  ).astype(np.float32),
        "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
    if answer.shape != (3, 2) or not np.isfinite(answer).all():
        raise AssertionError(f"served answer {answer}")
    print(f"cli export (python3 -m mmnn_sts_torch --export_path, a "
          f"subprocess): {time.perf_counter() - t0:.1f} s; ServingModel on "
          f"the card, batch 3: {answer.tolist()}")
    return run_counts


def recorded(fn, calls: list):
    """``fn``, appending each call's (args, kwargs, result) to ``calls``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    return call


def event_ms(fn, iters: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls after a
    warm-up: the device timeline between two markers, so where the host
    paces the work its gaps are in it."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_time(fn) -> tuple[float, int]:
    """(ms, launches) of the CUDA kernels of one call of ``fn`` after a
    warm-up, from torch.profiler: the device's busy time, without the
    host's gaps between kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return (sum(e.device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def read_csv_rows(path: Path) -> tuple[str, np.ndarray]:
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")]
                               for line in lines[1:]])


def run_cli(fd, args, where: Path, patches) -> tuple[int, float, int]:
    """``cli.main(args)`` on CLI_DEVICE in ``where`` with ``patches``
    started (in order): (rc, seconds, the kernel's launches)."""
    from mmnn_sts_torch import cli

    cwd = Path.cwd()
    os.chdir(where)
    try:
        for p in patches:
            p.start()
        fd.fused_bn_relu_matmul.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(args + ["--device", CLI_DEVICE])
        torch.cuda.synchronize()
        return rc, time.perf_counter() - t0, fd.fused_bn_relu_matmul.launches
    finally:
        for p in reversed(patches):
            p.stop()
        os.chdir(cwd)


def infer_phase(fd, seed: int, workdir: Path) -> dict:
    """Inference and classification through the port's CLI at full width,
    on the CLI phase's cohort and best weights (see the module docstring,
    phase 11). Returns the kernel launches of its runs."""
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop

    run_dir = workdir / "run"
    config = json.loads((workdir / "trained.json").read_text())
    config["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    infer_config = workdir / "infer.json"
    infer_config.write_text(json.dumps(config))
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    per_forward = sum(build_model(parse_config(str(infer_config)), True, True,
                                  False, True).image_model.block_config)

    run = functools.partial(run_cli, fd)

    # 1. survival inference with the attention maps
    counts, maps_calls, survival_calls = {}, [], []
    out = workdir / "infer_survival"
    rc, wall, launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--config", str(infer_config), "--output_path", str(out)], run_dir, [
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "eval_steps")),
            mock.patch.object(infer_run, "export_attention_maps", counted(
                infer_run.export_attention_maps, counts, "export")),
            mock.patch.object(infer_run, "attention_maps", recorded(
                infer_run.attention_maps, maps_calls)),
            mock.patch.object(infer_run, "inference_survival", recorded(
                infer_run.inference_survival, survival_calls))])
    n = len(test_uids)
    expected = per_forward * (counts["eval_steps"] + 2 * n)
    if rc != 0 or launches != expected:
        raise AssertionError(
            f"survival inference: rc {rc}, {launches} kernel launches, not "
            f"{per_forward} x ({counts['eval_steps']} eval steps + 2 x {n} "
            f"patients) = {expected}")
    header, rows = read_csv_rows(out / "survival_model_predictions.csv")
    if header != ("MRN,VS_pred,DM_pred,VS_event,DM_event,VS_duration,"
                  "DM_duration") or rows.shape != (n, 7) \
            or not np.isfinite(rows).all() \
            or sorted(rows[:, 0].astype(int)) != sorted(map(int, test_uids)):
        raise AssertionError(f"survival_model_predictions.csv: {header}, "
                             f"{rows.shape}")
    dirs = sorted(os.listdir(out / "attention_maps"))
    if dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"attention map directories {dirs}")
    peaks = []
    for d in dirs:
        for name in ("t1image", "t2image", "att_map", "att_map_cls1"):
            vol = load_nifti(str(out / "attention_maps" / d / f"{name}.nii.gz"))
            if vol.shape != (CLI_SIDE,) * 3:
                raise AssertionError(f"{d}/{name}: shape {vol.shape}")
            if name.startswith("att_map"):
                if not (vol.min() >= 0.0 and vol.max() <= 1.0
                        and vol.max() > 0.5):
                    raise AssertionError(f"{d}/{name}: range [{vol.min()}, "
                                         f"{vol.max()}]")
                peaks.append(vol.max())
    export_s = counts["export_s"][0]
    args, kw, _ = maps_calls[0]  # the first patient's call
    model, inputs = args[:2]
    maps_ms = event_ms(lambda: infer_run.attention_maps(*args, **kw))
    maps_busy, maps_kernels = kernel_time(
        lambda: infer_run.attention_maps(*args, **kw))
    c_indices = survival_calls[0][2]["c_indices"]
    print(f"infer survival: rc {rc}, {wall:.1f} s for {n} test patients; "
          f"kernel launches {launches} = {per_forward} x "
          f"({counts['eval_steps']} eval step + 2 x {n}); C-indices "
          f"{c_indices}; Grad-CAM export {export_s:.2f} s = "
          f"{export_s / n * 1e3:.1f} ms a patient (its forward, maps and "
          f"four NIfTI writes); attention_maps alone, one patient: "
          f"{maps_ms:.2f} ms (CUDA events, median of 3), of which CUDA "
          f"kernels {maps_busy:.2f} ms in {maps_kernels} launches "
          f"(torch.profiler); att_map peaks {min(peaks):.3f}.."
          f"{max(peaks):.3f}")

    # 2. Grad-CAM on the card: the kernel against the plain op, and the CPU
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = infer_run.attention_maps(*args, **kw)
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            plain = infer_run.attention_maps(*args, **kw)
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               reassociated_reference):
            control = infer_run.attention_maps(*args, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    cpu_model = copy.deepcopy(model).cpu()
    cpu_maps = infer_run.attention_maps(
        cpu_model, {k: v.cpu() for k, v in inputs.items()}, *args[2:], **kw)
    vs_plain = (got - plain).abs().max().item()
    vs_control = (control - plain).abs().max().item()
    vs_cpu = (got.cpu() - cpu_maps).abs().max().item()
    print(f"infer Grad-CAM, patient {test_uids[0]}, cudnn.allow_tf32 False: "
          f"kernel vs plain op max|diff| {vs_plain:.3e} (limit 1e-3); the "
          f"plain op with its product summed in two halves of K vs plain "
          f"{vs_control:.3e}; card vs CPU {vs_cpu:.3e} (limit 1e-2)")
    if not (vs_plain <= 1e-3 and vs_cpu <= 1e-2):
        raise AssertionError("the attention maps on the card disagree with "
                             "the plain op's or the CPU's")
    del cpu_model, cpu_maps

    # 3. the bootstrap
    boot_calls, survival_calls = [], []
    out = workdir / "infer_bootstrap"
    rc, boot_wall, boot_launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--bootstrap", "--no_gradcam", "--config", str(infer_config),
         "--output_path", str(out)], run_dir, [
            mock.patch.object(infer_run, "bootstrap_cindices", recorded(
                infer_run.bootstrap_cindices, boot_calls)),
            mock.patch.object(infer_run, "inference_survival", recorded(
                infer_run.inference_survival, survival_calls))])
    res = survival_calls[0][2]
    (preds, events, durations, resamples), _, (cs, _) = boot_calls[0]
    if rc != 0 or resamples.shape[0] != 50 or len(res["resample_c"]) < 1 \
            or not all(np.isfinite(res[k]).all() and (res[k] >= 0).all()
                       and (res[k] <= 1).all() for k in ("mean_c", "std_c")):
        raise AssertionError(f"bootstrap: rc {rc}, {resamples.shape[0]} "
                             f"resamples, means {res['mean_c']}, stds "
                             f"{res['std_c']}")
    cpu_cs, _ = infer_run.bootstrap_cindices(
        preds.cpu(), events.cpu(), durations.cpu(), resamples.cpu())
    vs_cpu = np.nanmax(np.abs(cs.cpu().numpy() - cpu_cs.numpy()))
    if not (vs_cpu <= 1e-6 and torch.equal(cs.isnan().cpu(), cpu_cs.isnan())):
        raise AssertionError(f"bootstrap C-indices, card vs CPU {vs_cpu}")
    boot_ms, boot_host_ms, _ = time_calls(lambda: infer_run.bootstrap_cindices(
        preds, events, durations, resamples))
    boot_busy, boot_kernels = kernel_time(lambda: infer_run.bootstrap_cindices(
        preds, events, durations, resamples))
    print(f"infer bootstrap: rc {rc}, {boot_wall:.1f} s; {resamples.shape[0]}"
          f" resamples of {n}, {len(res['resample_c'])} kept; mean C "
          f"{res['mean_c'].tolist()}, std {res['std_c'].tolist()}; card vs "
          f"CPU max|diff| {vs_cpu:.1e} (limit 1e-6); the batched C-index "
          f"(2 classes x {resamples.shape[0]} resamples): CUDA kernels "
          f"{boot_busy:.4f} ms in {boot_kernels} launches (torch.profiler), "
          f"{boot_ms:.4f} ms a call queued behind a sleep, {boot_host_ms:.4f}"
          f" ms of host time a call; the run's kernel launches "
          f"{boot_launches}")

    # 4. classification training, in a run directory of its own
    class_dir = workdir / "run_class"
    class_dir.mkdir()
    counts = {}
    out = class_dir / "out"
    epochs = 2
    rc, wall, class_launches = run(
        ["--images", "--preop", "--classification", "--blend", "--split",
         "--config", str(workdir / "config.json"), "--epochs", str(epochs),
         "--blend_update_interval", "1", "--output_path", str(out),
         "--checkpoint_dir", str(class_dir / "ck")], class_dir, [
            mock.patch.object(loop, "classification_train_step", counted(
                loop.classification_train_step, counts, "steps")),
            mock.patch.object(evaluate, "classification_eval_step", counted(
                evaluate.classification_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    blend = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if rc != 0 or [r["kind"] for r in rows] != ["classification_epoch"] * \
            epochs or not all(
                np.isfinite([r["train_loss"], r["val_loss"]]).all()
                and all(np.isnan(r[k]) or 0.0 <= r[k] <= 1.0
                        for k in ("train_f1", "val_f1")) for r in rows) \
            or not (blend.shape == (epochs + 1, 3)
                    and np.allclose(blend.sum(1), 1.0, atol=1e-5)
                    and not np.allclose(blend[-1], blend[0])):
        raise AssertionError(f"classification: rc {rc}, rows {rows}, blend "
                             f"{blend.tolist()}")
    fresh = build_model(parse_config(str(workdir / "config.json")), True,
                        True, False, True)
    checkpoint.load_params_npz(str(out / "model.npz"), fresh)
    expected = (counts["steps"] + counts["val_forwards"]) * per_forward
    if class_launches != expected:
        raise AssertionError(
            f"classification launched the kernel {class_launches} times, not"
            f" ({counts['steps']} steps + {counts['val_forwards']} validation"
            f" forwards) x {per_forward} = {expected}")
    print(f"infer classification training: rc {rc}, {wall:.1f} s; "
          f"{counts['steps']} steps of {TRAIN_BATCH} ({counts['steps'] // epochs}"
          f" an epoch), {counts['val_forwards']} validation forwards; kernel "
          f"launches {class_launches} = {expected} expected; blend weights "
          f"{blend[-1].tolist()}")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train loss"
              f" {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, train "
              f"F1 {r['train_f1']:.3f}, val F1 {r['val_f1']:.3f}")

    # 5. classification inference on the weights it trained
    config = json.loads((workdir / "config.json").read_text())
    config["Hyperparameters"]["model_weights"] = str(out / "model.npz")
    config["Preprocessing"] = {f"{s}_uid_location": str(class_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    class_config = workdir / "infer_class.json"
    class_config.write_text(json.dumps(config))
    class_test = (class_dir / "test_uids.txt").read_text().split()
    counts = {}
    out = workdir / "infer_classification"
    rc, wall, infer_launches = run(
        ["--inference", "--images", "--preop", "--classification", "--blend",
         "--config", str(class_config), "--output_path", str(out)],
        class_dir, [mock.patch.object(evaluate, "classification_eval_step",
                                      counted(evaluate.classification_eval_step,
                                              counts, "eval_steps"))])
    header, rows = read_csv_rows(out / "model_probabilities.csv")
    dirs = set(os.listdir(out / "attention_maps"))
    want_dirs = set()
    for row in rows:
        labels = "".join(str(int(v)) for v in row[3:5])
        preds = "".join(str(int(v > 0.5)) for v in row[1:3])
        correct = "".join("1" if a == b else "0" for a, b in zip(labels, preds))
        want_dirs.add(f"{correct}_{labels}_{preds}__patient_{int(row[0])}")
    expected = per_forward * (counts["eval_steps"] + len(class_test))
    if rc != 0 or header != "0,1,2,3,4" or rows.shape != (len(class_test), 5) \
            or not ((rows[:, 1:3] >= 0) & (rows[:, 1:3] <= 1)).all() \
            or dirs != want_dirs or infer_launches != expected:
        raise AssertionError(
            f"classification inference: rc {rc}, {header}, {rows.shape}, "
            f"directories {sorted(dirs)} vs {sorted(want_dirs)}, launches "
            f"{infer_launches} vs {expected}")
    print(f"infer classification: rc {rc}, {wall:.1f} s for "
          f"{len(class_test)} test patients; kernel launches {infer_launches}"
          f" = {per_forward} x ({counts['eval_steps']} eval step + "
          f"{len(class_test)} patients); directories agree with "
          f"model_probabilities.csv")
    return {"survival": launches, "classification": infer_launches,
            "per_classification_epoch": class_launches // epochs}


def kernel_dtypes(fd, seen: set):
    """A patch of the kernel's wrapper that adds each call's (x dtype, w
    dtype) to ``seen``. While it is active, read the launches from
    ``fd.fused_bn_relu_matmul.launches`` (the wrapper counts on the name it
    finds in its module)."""
    orig = fd.fused_bn_relu_matmul

    @functools.wraps(orig)
    def call(x, a, b, w):
        seen.add((x.dtype, w.dtype))
        return orig(x, a, b, w)

    return mock.patch.object(fd, "fused_bn_relu_matmul", call)


def check_bf16_calls(seen: set, where: str):
    if seen != {(torch.bfloat16, torch.bfloat16)}:
        raise AssertionError(f"{where}: the kernel's calls had x and w of "
                             f"{sorted(map(str, seen))}, not bfloat16 only")


def flat_update(params, before) -> torch.Tensor:
    return torch.cat([(p.detach() - b).flatten().float()
                      for p, b in zip(params, before)])


def bf16_train_phase(fd, seed: int) -> dict:
    """The flagship superstep with TPU.compute_dtype bfloat16 (see the module
    docstring, phase 7). Returns its launches and device times."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()
    cfg.image_model.name = CLI_MODEL
    cfg.image_model.spatial_size = [CLI_SIDE] * 3
    cfg.tpu.compute_dtype = "bfloat16"
    flags = dict(images=True, preop=True, postop=False, blend=True)
    spec = model_spec(cfg, **flags)
    model = build_model(cfg, **flags)
    per_forward = sum(model.image_model.block_config)  # 58 in DenseNet121
    weights = random_flat_weights(model, seed, to_jax_flat)
    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
    volumes = TRAIN_MICRO * TRAIN_BATCH

    def new_state(total_steps: int):
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        return create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, total_steps, 1), seed=seed)

    def superstep(state):
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=True)
        if not torch.isfinite(aux["loss"]):
            raise AssertionError("a bfloat16 superstep's loss is not finite")
        return aux

    def update_with(patch):
        """One augmented superstep from the initial state (the same draws
        every time) under ``patch``: (its output, its update, the kernel's
        launches)."""
        state = new_state(4)
        params = list(state.model.parameters())
        before = [p.detach().clone() for p in params]
        with patch:
            aux = superstep(state)
            torch.cuda.synchronize()
            launched = getattr(fd.fused_bn_relu_matmul, "launches", None)
        update = flat_update(params, before)
        if not torch.isfinite(update).all():
            raise AssertionError("a bfloat16 superstep's update is not finite")
        return aux, update, launched

    def rel(got, want):
        return ((got.float() - want.float()).norm()
                / want.float().norm()).item()

    seen = set()
    fd.fused_bn_relu_matmul.launches = 0
    got_aux, got, launched = update_with(kernel_dtypes(fd, seen))
    check_bf16_calls(seen, "bf16 superstep")
    if launched != per_forward * TRAIN_MICRO:
        raise AssertionError(f"a bfloat16 superstep launched the kernel "
                             f"{launched} times, not "
                             f"{per_forward * TRAIN_MICRO}")
    want_aux, want, _ = update_with(mock.patch.object(
        fd, "fused_bn_relu_matmul", fd.fused_bn_relu_matmul_reference))
    ctrl_aux, control, _ = update_with(mock.patch.object(
        fd, "fused_bn_relu_matmul", reassociated_reference))
    dists = {"update": (rel(got, want), rel(control, want)),
             "predictions": (rel(got_aux["preds"], want_aux["preds"]),
                             rel(ctrl_aux["preds"], want_aux["preds"]))}
    print(f"bf16 train: {TRAIN_MICRO} x {TRAIN_BATCH} volumes of "
          f"{tuple(inputs['image'].shape[2:])}, compute_dtype bfloat16, "
          f"augmentation on, dropout {cfg.image_model.dropout_prob}; "
          f"{launched} kernel launches, every call with bfloat16 x and w; "
          f"loss kernel {got_aux['loss'].item():.6f} plain "
          f"{want_aux['loss'].item():.6f} control "
          f"{ctrl_aux['loss'].item():.6f}; relative L2 to the plain op's, "
          f"kernel / control (the plain op with its product summed in two "
          f"halves of K), limit {BF16_CONTROL_FACTOR:g} x the control's: "
          + ", ".join(f"{k} {d:.3e} / {c:.3e}" for k, (d, c) in dists.items())
          + f"; update norm kernel / plain {got.norm() / want.norm():.4f}")
    bad = [k for k, (d, c) in dists.items() if not d <= BF16_CONTROL_FACTOR * c]
    if bad:
        raise AssertionError(f"the bfloat16 superstep with the kernel "
                             f"disagrees with the plain op's: {bad}")
    dist, ctrl = dists["update"]

    state = new_state(2 + TRAIN_TIMED)
    ms = timed_supersteps(lambda: superstep(state), volumes,
                          "bf16 train superstep with augmentation")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        superstep(state)
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof, float(np.median(ms)),
                         "bf16 augmented train superstep, wall the timed "
                         "median", top=10)
    return {"launches": launched, "update_rel_l2": dist,
            "control_rel_l2": ctrl, "busy_ms": kinds["busy"],
            "fused_ms": kinds.get("fused_bn_relu_matmul kernel", 0.0)}


def deviations(got: dict, want: dict) -> list:
    """(|got - want| / (TRAIN_TOLERANCE x max(1, |want|)), name) of each
    tensor of two same-keyed dicts; inf where ``got`` is not finite."""
    out = []
    for name, w in want.items():
        g = got[name].float()
        limit = TRAIN_TOLERANCE * max(1.0, w.float().abs().max().item())
        ratio = (g - w.float()).abs().max().item() / limit
        out.append((ratio if torch.isfinite(g).all() else float("inf"),
                    name))
    return out


def superstep_tensors(aux, model) -> dict:
    """The loss, the predictions, every summed gradient and every running
    statistic after a superstep, by name."""
    out = {"loss": aux["loss"], "preds": aux["preds"]}
    out.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    out.update({f"buffer {n}": b for n, b in model.named_buffers()})
    return out


def families_phase(fd, seed: int) -> dict:
    """Every image model name beyond the flagship's (FAMILIES), image-only
    at full width (see the module docstring, phase 8). Returns, by name,
    the kernel's launches per forward and per superstep, the peak memory
    and the times."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.ops.augment import eval_transform_batch
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    flags = dict(images=True, preop=False, postop=False, blend=False)
    rng = np.random.default_rng(seed + 8)
    tf32, torch.backends.cudnn.allow_tf32 = \
        torch.backends.cudnn.allow_tf32, False
    print(f"families: image-only, {CLI_SIDE}^3 x 2ch, Config() defaults, "
          f"random weights; eval forward of {TRAIN_BATCH}; augmented "
          f"survival superstep of {FAMILY_MICRO} x {TRAIN_BATCH} with the "
          f"kernel and with the plain op (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}), loss, predictions, summed "
          f"gradients and running statistics within {TRAIN_TOLERANCE:.0e} x "
          "max(1, |plain|); bfloat16 eval forward")
    results = {}
    for name in FAMILIES:
        cfg = Config()
        cfg.image_model.name = name
        cfg.image_model.spatial_size = [CLI_SIDE] * 3
        spec = model_spec(cfg, **flags)
        base = build_model(cfg, **flags)
        per_forward = sum(getattr(base, "block_config", ()))
        weights = random_flat_weights(base, seed, to_jax_flat)
        load_jax_npz(base, weights)
        inputs, events, durations = synthetic_split(
            rng, (FAMILY_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
        image = inputs["image"]
        vols = eval_transform_batch(image[0])

        def new_state():
            model = copy.deepcopy(base).to(CLI_DEVICE)
            return create_train_state(model, *make_optimizer(
                model.parameters(), TRAIN_LR, 4, 1), seed=seed)

        def superstep(state):
            return survival_train_superstep(state, image, events, durations,
                                            augment=True)

        state = new_state()
        model = state.model.eval()
        fd.fused_bn_relu_matmul.launches = 0
        with torch.no_grad():
            out = model(vols)
        torch.cuda.synchronize()
        launched = fd.fused_bn_relu_matmul.launches
        if out.shape != (TRAIN_BATCH, 2) or not torch.isfinite(out).all() \
                or launched != per_forward:
            raise AssertionError(f"{name} eval forward: {tuple(out.shape)}, "
                                 f"finite {bool(torch.isfinite(out).all())},"
                                 f" {launched} launches, not {per_forward}")
        with torch.no_grad():
            forward_ms = event_ms(lambda: model(vols))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fd.fused_bn_relu_matmul.launches = 0
        got = superstep(state)
        torch.cuda.synchronize()
        step_launches = fd.fused_bn_relu_matmul.launches
        peak = torch.cuda.max_memory_allocated()
        got = superstep_tensors(got, state.model)
        if step_launches != FAMILY_MICRO * per_forward:
            raise AssertionError(f"{name} superstep: {step_launches} "
                                 f"launches, not {FAMILY_MICRO * per_forward}")
        plain = new_state()
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            want = superstep_tensors(superstep(plain), plain.model)
        dev = deviations(got, want)
        bad = [(r, n) for r, n in dev if not r <= 1.0]
        if bad:
            raise AssertionError(f"{name} superstep, kernel vs plain op: "
                                 f"{sorted(bad)[-5:]}")
        del plain, want, got
        step_ms = event_ms(lambda: superstep(state), iters=1)

        cfg.tpu.compute_dtype = "bfloat16"
        model16 = build_model(cfg, **flags)
        load_jax_npz(model16, weights)
        model16.to(CLI_DEVICE).eval()
        seen = set()
        with kernel_dtypes(fd, seen), torch.no_grad():
            fd.fused_bn_relu_matmul.launches = 0
            out16 = model16(vols)
            torch.cuda.synchronize()
            launched16 = fd.fused_bn_relu_matmul.launches
        if per_forward:
            check_bf16_calls(seen, f"{name} bf16 eval forward")
        if out16.dtype != torch.bfloat16 or out16.shape != (TRAIN_BATCH, 2) \
                or not torch.isfinite(out16.float()).all() \
                or launched16 != per_forward:
            raise AssertionError(f"{name} bf16 eval forward: {out16!r}, "
                                 f"{launched16} launches")
        results[name] = dict(per_forward=launched, superstep=step_launches,
                             peak_gib=peak / 2**30, forward_ms=forward_ms,
                             superstep_ms=step_ms)
        worst = max(dev)
        print(f"  {name}: eval forward ({TRAIN_BATCH}, 2) finite, {launched} "
              f"launches, {forward_ms:.2f} ms (CUDA events); superstep "
              f"{step_launches} launches, {len(dev) - 2} gradients and "
              f"statistics, largest {worst[0]:.1%} of the limit "
              f"({worst[1]}), {step_ms:.1f} ms = "
              f"{FAMILY_MICRO * TRAIN_BATCH * 1e3 / step_ms:.1f} volumes/s "
              f"(TF32 off), max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"bf16 forward {launched16} launches"
              + (", every call bf16" if per_forward else "")
              + f", max|bf16 - fp32| {(out16.float() - out).abs().max():.3e}")
        del state, model, model16, base
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    return results


def remat_phase(fd, seed: int) -> dict:
    """The flagship superstep with TPU.remat off and on (see the module
    docstring, phase 9). Returns the launches, peaks and times of each."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    flags = dict(images=True, preop=True, postop=False, blend=True)
    cfg = Config()
    cfg.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(cfg, **flags)
    weights = random_flat_weights(build_model(cfg, **flags), seed,
                                  to_jax_flat)
    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
    tf32, torch.backends.cudnn.allow_tf32 = \
        torch.backends.cudnn.allow_tf32, False
    runs = {}
    for remat in (False, True):
        cfg.tpu.remat = remat
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        state = create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, 4, 1), seed=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fd.fused_bn_relu_matmul.launches = 0
        start.record()
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=False)
        end.record()
        torch.cuda.synchronize()
        runs[remat] = dict(
            tensors=superstep_tensors(aux, model),
            launches=fd.fused_bn_relu_matmul.launches,
            peak=torch.cuda.max_memory_allocated(),
            ms=start.elapsed_time(end))
        del state, model
    torch.backends.cudnn.allow_tf32 = tf32
    per_forward = sum(build_model(cfg, **flags).image_model.block_config)
    expected = {False: TRAIN_MICRO * per_forward,
                True: TRAIN_MICRO * (2 * per_forward - 1)}
    dev = deviations(runs[True]["tensors"], runs[False]["tensors"])
    bad = [(r, n) for r, n in dev if not r <= 1.0]
    launches = {k: v["launches"] for k, v in runs.items()}
    if bad or launches != expected:
        raise AssertionError(f"remat superstep: launches {launches} vs "
                             f"{expected}; beyond the limit {bad[-5:]}")
    worst = max(dev)
    print(f"remat: flagship superstep {TRAIN_MICRO} x {TRAIN_BATCH} at "
          f"{CLI_SIDE}^3, dropout {cfg.image_model.dropout_prob}, TF32 off: "
          f"TPU.remat on vs off, loss, predictions, {len(dev) - 2} summed "
          f"gradients and running statistics within {TRAIN_TOLERANCE:.0e} x "
          f"max(1, |off|): largest {worst[0]:.1%} ({worst[1]}); launches "
          f"{launches[True]} vs {launches[False]}; max_memory_allocated "
          f"{runs[True]['peak'] / 2**30:.2f} vs "
          f"{runs[False]['peak'] / 2**30:.2f} GiB; one superstep "
          f"{runs[True]['ms']:.1f} vs {runs[False]['ms']:.1f} ms (CUDA "
          "events, the first of each)")
    return {"launches": launches[True], "launches_off": launches[False],
            "peak_gib": runs[True]["peak"] / 2**30,
            "peak_gib_off": runs[False]["peak"] / 2**30}


def bf16_cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The survival run, its export and --inference with TPU.compute_dtype
    bfloat16 on the CLI phase's cohort (see the module docstring, phase
    12). Returns the kernel launches of its runs."""
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop

    config = json.loads((workdir / "config.json").read_text())
    config["TPU"] = {"compute_dtype": "bfloat16"}
    config_path = workdir / "config_bf16.json"
    config_path.write_text(json.dumps(config))
    run_dir = workdir / "run_bf16"
    run_dir.mkdir()
    out = run_dir / "out"
    per_forward = sum(build_model(parse_config(str(config_path)), True, True,
                                  False, True).image_model.block_config)

    def run(args, patches):
        """run_cli in run_dir, the kernel's calls checked for bfloat16."""
        seen = set()
        out = run_cli(fd, args, run_dir, [kernel_dtypes(fd, seen), *patches])
        check_bf16_calls(seen, f"bf16 {args[0]}")
        return out

    # 1. training, 2 epochs
    epochs, counts = 2, {}
    rc, wall, launches = run(
        ["--images", "--preop", "--survival", "--blend", "--split",
         "--config", str(config_path), "--epochs", str(epochs),
         "--blend_update_interval", "1", "--output_path", str(out)], [
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if rc != 0 or [r["epoch"] for r in rows] != list(range(1, epochs + 1)) \
            or not all(np.isfinite([r["train_loss"], r["val_loss"]]).all()
                       for r in rows) or launches != expected:
        raise AssertionError(f"bf16 CLI run: rc {rc}, rows {rows}, launches "
                             f"{launches} vs {expected}")
    fresh = build_model(parse_config(str(config_path)), True, True, False,
                        True)
    checkpoint.load_params_npz(str(out / "best_surv_model.npz"), fresh)
    print(f"bf16 cli run: rc {rc}, {wall:.1f} s, {epochs} epochs; "
          f"{counts['supersteps']} supersteps, {counts['val_forwards']} "
          f"validation forwards; kernel launches {launches} = {expected} "
          f"({launches // epochs} an epoch), every call with bfloat16 x and "
          f"w; best_surv_model.npz loads strictly into a fresh model")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train "
              f"loss {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, "
              f"train C {r['train_c']:.3f}, val C {r['val_c']:.3f}")

    # 2. the export, served on the card
    config["Hyperparameters"]["model_weights"] = str(
        out / "best_surv_model.npz")
    config["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    trained = workdir / "trained_bf16.json"
    trained.write_text(json.dumps(config))
    artifact = workdir / "model_bf16.pt"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mmnn_sts_torch", "--images", "--preop",
         "--survival", "--blend", "--config", str(trained), "--output_path",
         str(out), "--export_path", str(artifact), "--device", CLI_DEVICE],
        cwd=run_dir, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bf16 --export_path failed: "
                             f"{res.stderr[-3000:]}")
    export_s = time.perf_counter() - t0
    served = ServingModel(str(artifact), device=CLI_DEVICE)
    rng = np.random.default_rng(seed + 6)
    seen = set()
    with kernel_dtypes(fd, seen):
        fd.fused_bn_relu_matmul.launches = 0
        answer = served({
            "image": (rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2
                      * 500).astype(np.float32),
            "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
        served_launches = fd.fused_bn_relu_matmul.launches
    check_bf16_calls(seen, "bf16 served forward")
    if served.spec["compute_dtype"] != "bfloat16" \
            or answer.dtype != np.float32 or answer.shape != (3, 2) \
            or not np.isfinite(answer).all() or served_launches != per_forward:
        raise AssertionError(f"bf16 servable: spec {served.spec}, answer "
                             f"{answer!r}, launches {served_launches}")
    print(f"bf16 export (python3 -m mmnn_sts_torch --export_path, a "
          f"subprocess): {export_s:.1f} s; spec compute_dtype "
          f"{served.spec['compute_dtype']}; ServingModel on the card, batch 3,"
          f" {served_launches} launches with bfloat16 x and w: float32 "
          f"{answer.tolist()}")
    del served

    # 3. --inference --survival with Grad-CAM on the test patients
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    counts = {}
    infer_out = workdir / "infer_bf16"
    rc, wall, infer_launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--config", str(trained), "--output_path", str(infer_out)], [
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "eval_steps")),
            mock.patch.object(infer_run, "export_attention_maps", counted(
                infer_run.export_attention_maps, counts, "export"))])
    n = len(test_uids)
    expected = per_forward * (counts["eval_steps"] + 2 * n)
    dirs = sorted(os.listdir(infer_out / "attention_maps"))
    if rc != 0 or infer_launches != expected \
            or dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"bf16 inference: rc {rc}, launches "
                             f"{infer_launches} vs {expected}, {dirs}")
    peaks = []
    for d in dirs:
        for name in ("att_map", "att_map_cls1"):
            vol = load_nifti(str(infer_out / "attention_maps" / d /
                                 f"{name}.nii.gz"))
            if not (vol.shape == (CLI_SIDE,) * 3 and vol.min() >= 0.0
                    and vol.max() <= 1.0 and vol.max() > 0.5):
                raise AssertionError(f"bf16 {d}/{name}: {vol.shape}, range "
                                     f"[{vol.min()}, {vol.max()}]")
            peaks.append(vol.max())
    print(f"bf16 infer survival: rc {rc}, {wall:.1f} s for {n} test "
          f"patients; kernel launches {infer_launches} = {per_forward} x "
          f"({counts['eval_steps']} eval step + 2 x {n}), every call with "
          f"bfloat16 x and w; Grad-CAM export {counts['export_s'][0]:.2f} s;"
          f" att_map peaks {min(peaks):.3f}..{max(peaks):.3f}")
    return {"per_epoch": launches // epochs, "served": served_launches,
            "inference": infer_launches}


def wide_cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The slice's paths through the CLI on the CLI phase's cohort (see the
    module docstring, phase 13). Returns the kernel launches of its runs."""
    import importlib.util

    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop, lr_finder

    base = json.loads((workdir / "config.json").read_text())

    def config(name: str, model: str, **hyper) -> Path:
        cfg = copy.deepcopy(base)
        cfg["ImageModel"]["name"] = model
        cfg["Hyperparameters"].update(hyper)
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return path

    def uid_files(cfg_path: Path, run_dir: Path, weights: Path) -> Path:
        cfg = json.loads(cfg_path.read_text())
        cfg["Hyperparameters"]["model_weights"] = str(weights)
        cfg["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                                for s in ("train", "val", "test")}
        path = cfg_path.with_name(cfg_path.stem + "_trained.json")
        path.write_text(json.dumps(cfg))
        return path

    # 1. the image-only survival run of densenet201, its export served
    cfg_path = config("wide", WIDE_CLI_MODEL)
    run_dir = workdir / "run_wide"
    run_dir.mkdir()
    out = run_dir / "out"
    per_forward = sum(build_model(parse_config(str(cfg_path)), True, False,
                                  False, False).block_config)
    counts = {}
    rc, wall, launches = run_cli(fd, [
        "--images", "--survival", "--split", "--config", str(cfg_path),
        "--epochs", str(WIDE_CLI_EPOCHS), "--output_path", str(out)],
        run_dir, [
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if rc != 0 or [r["epoch"] for r in rows] != list(
            range(1, WIDE_CLI_EPOCHS + 1)) or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all()
            for r in rows) or launches != expected:
        raise AssertionError(f"{WIDE_CLI_MODEL} CLI run: rc {rc}, rows "
                             f"{rows}, launches {launches} vs {expected}")
    best = out / "best_surv_model.npz"
    checkpoint.load_params_npz(str(best), build_model(
        parse_config(str(cfg_path)), True, False, False, False))
    wide_launches = launches
    print(f"wide cli --images --survival --split, {WIDE_CLI_MODEL}: rc {rc}, "
          f"{wall:.1f} s, {WIDE_CLI_EPOCHS} epochs; {counts['supersteps']} "
          f"supersteps, {counts['val_forwards']} validation forwards; kernel "
          f"launches {launches} = {expected} ({per_forward} a forward); "
          f"best_surv_model.npz loads strictly")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train "
              f"loss {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, "
              f"train C {r['train_c']:.3f}, val C {r['val_c']:.3f}")
    trained = uid_files(cfg_path, run_dir, best)
    artifact = workdir / "model_wide.pt"
    rc, export_s, _ = run_cli(fd, [
        "--images", "--survival", "--config", str(trained), "--output_path",
        str(out), "--export_path", str(artifact)], run_dir, [])
    served = ServingModel(str(artifact), device=CLI_DEVICE)
    rng = np.random.default_rng(seed + 9)
    fd.fused_bn_relu_matmul.launches = 0
    answer = served((rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2
                     * 500).astype(np.float32))
    served_launches = fd.fused_bn_relu_matmul.launches
    if rc != 0 or answer.shape != (3, 2) or not np.isfinite(answer).all() \
            or served_launches != per_forward:
        raise AssertionError(f"{WIDE_CLI_MODEL} export: rc {rc}, answer "
                             f"{answer!r}, launches {served_launches}")
    print(f"wide cli --export_path (in process): {export_s:.1f} s; "
          f"ServingModel on the card, batch 3, {served_launches} launches: "
          f"{answer.tolist()}")
    del served

    # 2. tinycnn inside the multimodal blend model, then --inference with
    # Grad-CAM (conv5 is its target; it has no bottleneck)
    cfg_path = config("tinycnn", "tinycnn")
    run_dir = workdir / "run_tinycnn"
    run_dir.mkdir()
    out = run_dir / "out"
    rc, wall, launches = run_cli(fd, [
        "--images", "--preop", "--survival", "--blend", "--split",
        "--config", str(cfg_path), "--epochs", "1", "--output_path",
        str(out)], run_dir, [])
    if rc != 0 or launches != 0:
        raise AssertionError(f"tinycnn CLI run: rc {rc}, {launches} "
                             "launches")
    trained = uid_files(cfg_path, run_dir, out / "best_surv_model.npz")
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    infer_out = workdir / "infer_tinycnn"
    counts = {}
    rc, infer_wall, _ = run_cli(fd, [
        "--inference", "--images", "--preop", "--survival", "--blend",
        "--config", str(trained), "--output_path", str(infer_out)], run_dir,
        [mock.patch.object(infer_run, "export_attention_maps", counted(
            infer_run.export_attention_maps, counts, "export"))])
    dirs = sorted(os.listdir(infer_out / "attention_maps"))
    if rc != 0 or dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"tinycnn inference: rc {rc}, {dirs}")
    peaks = []
    for d in dirs:
        for name in ("att_map", "att_map_cls1"):
            vol = load_nifti(str(infer_out / "attention_maps" / d /
                                 f"{name}.nii.gz"))
            if not (vol.shape == (CLI_SIDE,) * 3 and vol.min() >= 0.0
                    and vol.max() <= 1.0):
                raise AssertionError(f"tinycnn {d}/{name}: {vol.shape}, "
                                     f"range [{vol.min()}, {vol.max()}]")
            peaks.append(vol.max())
    print(f"tinycnn cli --images --preop --survival --blend, 1 epoch: "
          f"{wall:.1f} s, 0 launches; --inference with Grad-CAM on "
          f"{len(test_uids)} test patients: {infer_wall:.1f} s (export "
          f"{counts['export_s'][0]:.2f} s), att_map peaks "
          f"{min(peaks):.3f}..{max(peaks):.3f}")

    # 3. the LR range test on the flagship model
    run_dir = workdir / "run_lr"
    run_dir.mkdir()
    sweeps = []
    rc, wall, launches = run_cli(fd, [
        "--lr_finder", "--images", "--preop", "--survival", "--split",
        "--config", str(workdir / "config.json"), "--output_path",
        str(run_dir / "out")], run_dir,
        [mock.patch.object(lr_finder, "find_lr", recorded(lr_finder.find_lr,
                                                          sweeps))])
    lrs, losses = sweeps[0][2]
    flagship = sum(build_model(parse_config(str(workdir / "config.json")),
                               True, True, False, False)
                   .image_model.block_config)
    best_lr = lrs[int(np.nanargmin(losses))]
    png = (run_dir / "lr_finder.png").exists()
    if rc != 0 or len(lrs) != LR_SWEEP_STEPS or len(losses) != LR_SWEEP_STEPS \
            or np.float32(lrs[0]) != np.float32(1e-7) \
            or not np.isfinite(best_lr) \
            or launches != LR_SWEEP_STEPS * flagship \
            or png != bool(importlib.util.find_spec("matplotlib")):
        raise AssertionError(f"--lr_finder: rc {rc}, {len(lrs)} rates from "
                             f"{lrs[:1]}, {len(losses)} losses, min-loss lr "
                             f"{best_lr}, {launches} launches, png {png}")
    finite = int(np.isfinite(losses).sum())
    print(f"cli --lr_finder --images --preop --survival ({CLI_MODEL}): rc "
          f"{rc}, {wall:.1f} s; {len(lrs)} steps from lr {lrs[0]:.3e} to "
          f"{lrs[-1]:.3e}, {launches} launches ({flagship} a step); "
          f"{finite} finite smoothed losses, min-loss lr {best_lr:.3e}; "
          f"lr_finder.png written: {png}")
    return {"launches": wide_launches, "per_forward": per_forward,
            "served": served_launches, "lr_finder": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(REPO))
    from mmnn_sts_torch.kernels import build
    from mmnn_sts_torch.ops import fused_dense as fd

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    print(smi)
    # float32 matmuls in full float32 (the plain op's reference product);
    # cuDNN convolutions keep PyTorch's default (TF32 allowed)
    torch.backends.cuda.matmul.allow_tf32 = False
    import importlib.util

    print("host packages: " + json.dumps({
        m: bool(importlib.util.find_spec(m))
        for m in ("pandas", "matplotlib", "yaml")}))
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    rows = kernel_phase(fd, args.seed, REPO / "chiprun_out")
    sweep_phase(fd, args.seed, REPO / "chiprun_out")
    wide = wide_kernel_phase(fd, args.seed, REPO / "chiprun_out")
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_phase(fd, args.seed, Path(tmp))
    backward = backward_phase(fd, args.seed, REPO / "chiprun_out")
    train_launches = train_phase(fd, args.seed)
    bf16_train = bf16_train_phase(fd, args.seed)
    families = families_phase(fd, args.seed)
    remat = remat_phase(fd, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_phase(fd, args.seed, Path(tmp))
        infer = infer_phase(fd, args.seed, Path(tmp))
        bf16_cli = bf16_cli_phase(fd, args.seed, Path(tmp))
        wide_cli = wide_cli_phase(fd, args.seed, Path(tmp))

    main_path = [r for r in rows if r["batch"] == 8 and r["dtype"] == "float32"]
    bf16_path = [r for r in rows
                 if r["batch"] == 8 and r["dtype"] == "bfloat16"]
    entry = {
        "name": "fused_bn_relu_matmul",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/fused_bn_relu_matmul.cu",
        "replaces": "mmnn_sts_tpu/ops/pallas/fused_dense.py:58",
        "launches": launches,
        # one served batch-8 forward: the sum over its 58 calls
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": sum(r["ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            r["bound_ms"] for r in main_path if r["bound_by"] == by)),
        "library_ms": None,  # no single PyTorch call computes this function
        # torch.matmul(h, w) on a precomputed h: the product alone
        "gemm_ms": sum(r["gemm_ms"] for r in main_path),
        "host_us_per_call": sum(r["host_us"] for r in main_path)
        / len(main_path),
        # the flagship training superstep: 58 calls per microbatch x 8
        "launches_per_superstep": train_launches,
        # the CLI run: 3 epochs of 2 supersteps (464 each) and one
        # validation forward (58)
        "launches_cli_run": cli["launches"],
        "launches_per_cli_epoch": cli["per_epoch"],
        # --inference of the 15 test patients: 58 x (1 eval step + 2 x 15:
        # each patient's Grad-CAM forward and its own forward); the same
        # for classification with one forward a patient; a classification
        # epoch: (9 steps + 1 validation forward) x 58
        "launches_inference_survival": infer["survival"],
        "launches_inference_classification": infer["classification"],
        "launches_per_classification_epoch": infer["per_classification_epoch"],
        # its backward (the JAX package's _bwd in plain PyTorch), the sum
        # over the 58 shapes of one microbatch of 8
        "backward_ms": sum(r["ms"] for r in backward),
        "backward_plain_ms": sum(r["plain_ms"] for r in backward),
        "backward_bound_ms": sum(r["bound_ms"] for r in backward),
        "backward_max_rel_err": max(r["max_rel_err"] for r in backward),
        # the kernel's launches in one eval forward of each image model
        # (the families phase; 0 where the model has no bottleneck)
        "launches_per_forward_by_model": {
            "densenet121": train_launches // TRAIN_MICRO,
            **{k: v["per_forward"] for k, v in families.items()}},
        # TPU.remat: the flagship superstep, each wrapped bottleneck's
        # forward run again in the backward (8 x (58 + 57))
        "launches_remat_superstep": remat["launches"],
        # --lr_finder on the flagship: 100 one-microbatch supersteps x 58
        "launches_lr_finder": wide_cli["lr_finder"],
        # the image-only densenet201 CLI run: 2 epochs of 2 supersteps
        # (8 x 98) and one validation forward (98) each
        "launches_densenet201_cli_run": wide_cli["launches"],
        # densenet264's 130 calls at batch 8: the sums as for DenseNet121's
        "densenet264_ms": wide["float32"]["ms"],
        "densenet264_plain_ms": wide["float32"]["plain_ms"],
        "densenet264_bound_ms": wide["float32"]["bound_ms"],
        "densenet264_gemm_ms": wide["float32"]["gemm_ms"],
    }
    # TPU.compute_dtype bfloat16: the tensor-core kernel. Its 58 calls of one
    # batch-8 forward against the plain op, cuBLAS's product alone and the
    # bound; its launches in the bfloat16 served forward (every call of the
    # bfloat16 phases is checked to have bfloat16 x and w), the bfloat16
    # superstep (58 x 8), a bfloat16 CLI epoch (2 supersteps and one
    # validation forward) and its --inference with Grad-CAM
    # (58 x (1 + 2 x 15 patients))
    bf16_entry = {
        "name": "fused_bn_relu_matmul_bf16",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/fused_bn_relu_matmul_bf16.cu",
        "replaces": "mmnn_sts_tpu/ops/pallas/fused_dense.py:58",
        "launches": bf16_cli["served"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "ms": sum(r["ms"] for r in bf16_path),
        "plain_ms": sum(r["plain_ms"] for r in bf16_path),
        "bound_ms": sum(r["bound_ms"] for r in bf16_path),
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            r["bound_ms"] for r in bf16_path if r["bound_by"] == by)),
        "library_ms": None,  # no single PyTorch call computes this function
        # torch.matmul(h, w) on a precomputed h: the product alone
        "gemm_ms": sum(r["gemm_ms"] for r in bf16_path),
        "host_us_per_call": sum(r["host_us"] for r in bf16_path)
        / len(bf16_path),
        "ms_batch32": sum(r["ms"] for r in rows if r["batch"] == 32
                          and r["dtype"] == "bfloat16"),
        "launches_per_superstep": bf16_train["launches"],
        "launches_per_cli_epoch": bf16_cli["per_epoch"],
        "launches_inference_survival": bf16_cli["inference"],
        "superstep_fused_ms": bf16_train["fused_ms"],
        "densenet264_ms": wide["bfloat16"]["ms"],
        "densenet264_plain_ms": wide["bfloat16"]["plain_ms"],
        "densenet264_bound_ms": wide["bfloat16"]["bound_ms"],
        "densenet264_gemm_ms": wide["bfloat16"]["gemm_ms"],
    }
    print(json.dumps({"kernels": [entry, bf16_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
