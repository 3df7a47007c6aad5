#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmnn_sts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure is an uncaught exception and a nonzero exit:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all at once) and prints the seconds taken.
3. Kernel: calls fused_bn_relu_matmul on the card at every (M, Cin) shape of
   DenseNet121's 58 bottlenecks at 64^3, for every batch bucket of the
   servable (1, 2, 4, 8, 16, 32), in float32 and bfloat16, and holds each
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
   to enqueue a call, beside the least time the card could take.
   Then times every launch plan the kernel takes at every shape of every
   bucket in float32, each checked against the plain version, beside the
   plan launch_plan picks (chiprun_out/plan_sweep.jsonl).
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
   predictions and every summed gradient must agree within 1e-2 x
   max(1, max |plain|); a third superstep with the plain op's product
   summed in another order shows how far roundoff alone moves them. One
   superstep with a ragged-tail mask: a finite loss and finite gradients.
   Then, with cuDNN's TF32 on (PyTorch's
   default) and dropout 0.2 as configured: a warm-up and 6 timed
   supersteps (CUDA events; volumes/s, peak memory), one profiled
   superstep (device busy share, kernel time by kind, the fused kernel's
   and the backward's shares), two validation steps with their C-indices
   and two blend updates. The first and the last superstep draw the same
   dropout masks (the generator is rewound), and the last one's loss on
   the fixed batch must be below the first's.
7. Prints the kernels' JSON line, the card's line, and last
   {"ok": true, "device": {...}}.

Per-shape kernel results go to chiprun_out/chip_smoke_kernels.jsonl, the
backward's to chiprun_out/chip_smoke_backward.jsonl.
"""

from __future__ import annotations

import argparse
import functools
import io
import json
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
                bm, bn, split_k = fd.launch_plan(m, k, n, sms)
                ms, host_ms, paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul(x, a, b, w))
                plain_ms, plain_host_ms, plain_paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul_reference(x, a, b, w))
                bound, bound_by = bound_ms(m, k, n, dtype_name)
                rows.append(dict(
                    batch=batch, dtype=dtype_name, block=block, m=m, cin=k,
                    cout=n, bm=bm, bn=bn, split_k=split_k,
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
    print("kernel fused_bn_relu_matmul vs plain, per block (sums over the "
          "block's calls: device ms, calls queued behind a sleep; paced ms, "
          "no sleep; host us to enqueue; max_rel_err limit "
          f"{TOLERANCE['float32']:.0e} float32, {TOLERANCE['bfloat16']:.0e} "
          "bfloat16; every shape also bit-equal over two calls and NaN rows "
          "as the plain version's; gemm_ms: torch.matmul(h, w) on a "
          "precomputed h, the product alone, not the same function):")
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
              f"bound_ms={tot['bound_ms']:.4f} ({rs[0]['bound_by']})")
        if dtype == "float32":  # bfloat16 takes the same plans
            print("    plan Cin:BMxBN/split(CTAs) " + " ".join(
                f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}({r['ctas']})"
                for r in rs))
    for batch in BATCH_SIZES:
        rs = [r for r in rows if r["batch"] == batch and r["dtype"] == "float32"]
        print(f"  B={batch} float32, {len(rs)} calls: kernel_ms "
              f"{sum(r['ms'] for r in rs):.4f} paced "
              f"{sum(r['paced_ms'] for r in rs):.4f} plain_ms "
              f"{sum(r['plain_ms'] for r in rs):.4f} paced "
              f"{sum(r['plain_paced_ms'] for r in rs):.4f} gemm_ms "
              f"{sum(r['gemm_ms'] for r in rs):.4f} bound_ms "
              f"{sum(r['bound_ms'] for r in rs):.4f}")
    return rows


def sweep_phase(fd, seed: int, out_dir: Path):
    """Every launch plan the kernel takes (each tile of ``fd.TILES`` with
    every K-split ``fd.max_split`` admits) at every (M, Cin) of every batch
    bucket in float32: each result held against the plain version, and
    its device time. Prints, per block, the sum of ``launch_plan``'s plans
    beside the sum of each shape's fastest plan; every timing goes to
    chiprun_out/plan_sweep.jsonl."""
    from mmnn_sts_torch.infer.export import BATCH_SIZES
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    model, n = densenet121(), BOTTLENECK_OUT
    sms = fd.sm_count(torch.cuda.current_device())
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for batch in BATCH_SIZES:
        for block, m, k in bottleneck_shapes(model, batch):
            x, a, b, w = operands(gen, m, k, torch.float32)
            want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
            chosen = fd.launch_plan(m, k, n, sms)
            for plan in ((bm, bn, split) for bm, bn in fd.TILES
                         for split in range(1, fd.max_split(k) + 1)):
                got = fd._launch(x, a, b, w, plan)
                rel = ((got - want).abs().max() / want.abs().max()).item()
                if not rel <= TOLERANCE["float32"]:
                    raise AssertionError(f"plan {plan} at M={m} Cin={k}: "
                                         f"rel err {rel:.2e}")
                rows.append(dict(
                    batch=batch, block=block, m=m, cin=k, bm=plan[0],
                    bn=plan[1], split_k=plan[2],
                    ctas=fd.plan_ctas(m, n, *plan), chosen=plan == chosen,
                    ms=time_calls(lambda: fd._launch(x, a, b, w, plan))[0]))
    with open(out_dir / "plan_sweep.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print("sweep float32: per block, sum of device ms over its calls with "
          "launch_plan's plans and with each shape's fastest plan")
    blocks = {}
    for r in rows:
        blocks.setdefault((r["batch"], r["block"]), {}).setdefault(
            r["cin"], []).append(r)
    for (batch, block), shapes in blocks.items():
        chosen = sum(r["ms"] for rs in shapes.values() for r in rs
                     if r["chosen"])
        best = [min(rs, key=lambda r: r["ms"]) for rs in shapes.values()]
        print(f"  B={batch} block{block}: chosen {chosen:.4f} ms, fastest "
              f"{sum(r['ms'] for r in best):.4f} ms; fastest plans " + " ".join(
                  f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}({r['ctas']})"
                  for r in best))


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
    """The plain version with its product summed as two halves of K: the
    same function, its sums in another order (a control for how far
    roundoff alone moves a superstep)."""
    from mmnn_sts_torch.ops.fused_dense import fused_bn_relu_matmul_reference

    k = x.shape[1] // 2
    return (fused_bn_relu_matmul_reference(x[:, :k], a[:k], b[:k], w[:k])
            + fused_bn_relu_matmul_reference(x[:, k:], a[k:], b[k:], w[k:]))


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
        kernel's wrapper: (its output, its summed gradients)."""
        state = new_state(False, 4)
        with mock.patch.object(fd, "fused_bn_relu_matmul", op):
            aux = superstep(state)
        return aux, [p.grad for p in state.model.parameters()]

    def deviations(aux, grads):
        """(|diff| / (TRAIN_TOLERANCE x max(1, |plain|)), name) of the loss,
        the predictions and each summed gradient against the plain op's."""
        out = []
        for name, g, w in [("loss", aux["loss"], want["loss"]),
                           ("preds", aux["preds"], want["preds"])] + [
                (f"grad {n}", g, w) for n, g, w in zip(names, grads,
                                                       want_grads)]:
            limit = TRAIN_TOLERANCE * max(1.0, w.abs().max().item())
            ratio = (g - w).abs().max().item() / limit
            out.append((ratio if torch.isfinite(g).all() else float("inf"),
                        name))
        return out

    kernel_state = new_state(False, 4)
    names = [n for n, _ in kernel_state.model.named_parameters()]
    fd.fused_bn_relu_matmul.launches = 0
    got = superstep(kernel_state)
    torch.cuda.synchronize()
    launched = fd.fused_bn_relu_matmul.launches
    if launched != 58 * TRAIN_MICRO:
        raise AssertionError(f"a superstep launched the kernel {launched} "
                             f"times, not {58 * TRAIN_MICRO}")
    want, want_grads = run_with(fd.fused_bn_relu_matmul_reference)
    kernel_dev = deviations(
        got, [p.grad for p in kernel_state.model.parameters()])
    bad = [(r, n) for r, n in kernel_dev if not r <= 1.0]
    if bad:
        raise AssertionError(f"superstep, kernel vs plain op beyond "
                             f"{TRAIN_TOLERANCE:.0e} x max(1, |plain|): {bad}")
    # the control: the plain op with its product summed in another order
    control_dev = deviations(*run_with(reassociated_reference))
    print(f"train superstep: {launched} kernel launches; loss kernel "
          f"{got['loss'].item():.6f} plain {want['loss'].item():.6f}; preds "
          f"{tuple(got['preds'].shape)}; loss, preds and "
          f"{len(kernel_dev) - 2} summed gradients within {TRAIN_TOLERANCE:.0e}"
          f" x max(1, |plain|): largest {max(kernel_dev)[0]:.1%} of it "
          f"({max(kernel_dev)[1]}); the plain op with its product summed in "
          f"two halves of K, against the plain op: largest "
          f"{max(control_dev)[0]:.1%} ({max(control_dev)[1]})")
    del want, want_grads

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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = superstep(state)  # warm-up
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        if i == TRAIN_TIMED - 1:  # the last draws the first's dropout masks
            state.generator.set_state(rewind)
        starts[i].record()
        last = superstep(state)
        ends[i].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    ms = np.array([s.elapsed_time(e) for s, e in zip(starts, ends)])
    rate = volumes * 1e3 / ms
    peak = torch.cuda.max_memory_allocated()
    print(f"train superstep timing ({TRAIN_TIMED} after a warm-up, CUDA "
          f"events): median {np.median(ms):.1f} ms (min {ms.min():.1f}, max "
          f"{ms.max():.1f}; host wall {wall:.1f} ms a superstep) = "
          f"{np.median(rate):.1f} volumes/s (min {rate.min():.1f}, max "
          f"{rate.max():.1f}); max_memory_allocated {peak / 2**30:.2f} GiB")
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
    return launched


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
    with tempfile.TemporaryDirectory() as tmp:
        launches = serve_phase(fd, args.seed, Path(tmp))
    backward = backward_phase(fd, args.seed, REPO / "chiprun_out")
    train_launches = train_phase(fd, args.seed)

    main_path = [r for r in rows if r["batch"] == 8 and r["dtype"] == "float32"]
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
        # the flagship training superstep: 58 calls per microbatch x 8
        "launches_per_superstep": train_launches,
        # its backward (the JAX package's _bwd in plain PyTorch), the sum
        # over the 58 shapes of one microbatch of 8
        "backward_ms": sum(r["ms"] for r in backward),
        "backward_plain_ms": sum(r["plain_ms"] for r in backward),
        "backward_bound_ms": sum(r["bound_ms"] for r in backward),
        "backward_max_rel_err": max(r["max_rel_err"] for r in backward),
    }
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
