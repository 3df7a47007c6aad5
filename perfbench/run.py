"""The benchmark's one command:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the directory that holds ``BENCHMARK.json``. One process, one
run: set-up, a window of whole training epochs of at least ``--seconds``,
with ``--trace 1`` one more epoch under the profiler, then the check of
what the program produced against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number beside its limit); the numbers
compared are also the last lines of standard error.

``--trace 0`` reports the cell's end-to-end metrics (``setup_s``, the
window's ``train_volumes_per_s`` and ``peak_mem_gib``), ``--trace 1`` its
per-layer metrics, each read by ``perfbench/metrics/<name>.py`` from the
run (a reader that finds nothing to read leaves its metric out).

It runs on one CUDA card and nowhere else: without one it exits 1 and
prints no result. The program's only build cache is its own
``mmnn_sts_torch/kernels/_build/``, inside the checkout; the loop's
best-model files go under ``TMPDIR``.
"""

STARTED = __import__("time").perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mmnn_sts_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def measure(cell, seed: int, seconds: float, trace: bool, device,
            started: float) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields."""
    import torch

    from . import check
    from .training import run_program

    run = run_program(cell, seed, seconds, trace, device, started)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        window = {
            "setup_s": run.setup_s,
            "train_volumes_per_s": run.train_volumes / run.window_s,
            "peak_mem_gib": run.peak_reserved / 2 ** 30,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": window[m["name"]],
                                  "unit": m["unit"]}
    t_ref = time.perf_counter()
    ref = check.reference_side(cell, run, device)
    values = check.readings(check.program_side(run, ref["weights"]), ref)
    t_ref = time.perf_counter() - t_ref
    correct, checks = check.judge(values, cell.limits, run.failed_steps)
    result = {
        "correct": correct,
        "attempted": run.supersteps,
        "failed": run.failed_steps,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": run.peak_reserved,
        },
    }
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    print(f"window {run.window_s!r} s, {run.window_epochs} epochs, "
          f"{run.train_volumes} training volumes, setup {run.setup_s!r} s, "
          f"graph captures {run.capture_s!r} s, captures in the window "
          f"{run.captures_in_window}, the check {t_ref!r} s", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from .cells import resolve

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 1
    cell = resolve(args.workload)
    device = torch.device("cuda", 0)
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     device, STARTED)
    print(f"card {result['device']['kind']}, power limit {power_limit()}",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
