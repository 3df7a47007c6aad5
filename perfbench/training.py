"""One benchmark run of a training cell: the program under test is
``mmnn_sts_torch``'s survival training loop, driven as its command line
drives it (``--images [--preop] --survival [--blend]`` with the
configuration's ``TPU`` settings), over a cohort and weights that the
benchmark makes from the seed (``inputs.py``).

The run, in order:

1. Set-up: the weights and the cohort on the device, the model (built on
   the meta device, then given the weights), its optimizer, schedule and
   train state, and ``train_survival`` started with the loop settings the
   command line gives it. Its first ``warmup_epochs`` epochs are set-up:
   the first run of each step body is eager and the second captures its
   CUDA graph (the step's at the second superstep, the ragged tail's and
   the validation forward's in the second epoch), and the kernels build on
   a checkout's first run.
2. The window: whole epochs, each from the entry of one epoch's
   ``survival_train_epoch`` to the next's, so the loop's own work between
   epochs (the read-back, the host C-indices, validation, the best
   ``.npz`` save, a blend update every ``blend_update_interval`` epochs) is
   inside it. It ends at the first epoch boundary at least ``seconds``
   after it began.
3. With ``trace``, one more epoch under ``torch.profiler`` (CPU and CUDA,
   kept in memory).
4. The loop is stopped at that boundary (``StopWindow``, raised before the
   next epoch does any work), the best-model writer drained, the peak
   memory read, and the program's state freed but for what the comparison
   needs, all of it from the warm-up epochs, which the reference follows
   from the seed: every superstep's loss and training predictions (the
   masked tails' included), the
   momentum after the first superstep (the first gradient as the optimizer
   takes it), the parameters after the third, and the last warm-up epoch's
   validation predictions (the first graphed validation forward).

The hooks that read these are two: ``TrainState.begin_step`` of the run's
state (called on the host before each superstep, outside any graph) and
the loop module's ``survival_train_epoch`` (the epoch call). Neither
changes what the program computes.
"""

from __future__ import annotations

import dataclasses
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from . import inputs
from .trace import Trace


class StopWindow(Exception):
    """Raised at an epoch boundary to end the program's loop."""


@dataclasses.dataclass
class ProgramRun:
    """What a run of the program leaves for the metrics and the check."""

    setup_s: float = 0.0
    window_s: float = 0.0
    window_epochs: int = 0
    train_volumes: int = 0
    val_volumes: int = 0
    supersteps: int = 0
    failed_steps: int = 0
    peak_reserved: int = 0
    capture_s: float = 0.0
    captures_in_window: int = 0
    trace: Trace | None = None
    profiled: dict = dataclasses.field(default_factory=dict)
    step_losses: list = dataclasses.field(default_factory=list)
    step_preds: list = dataclasses.field(default_factory=list)
    first_momentum: dict = dataclasses.field(default_factory=dict)
    params_after: dict = dataclasses.field(default_factory=dict)
    checked_steps: int = 3
    followed_epochs: int = 0
    val_preds: torch.Tensor | None = None
    cohort: dict = dataclasses.field(default_factory=dict)
    seeds: dict = dataclasses.field(default_factory=dict)
    steps_per_epoch: int = 0


def program_config(cell):
    """The program's ``Config`` of a cell, as its command line would read
    it from a configuration file."""
    from mmnn_sts_torch.config import (
        Config, HyperparametersConfig, ImageModelConfig, TPUConfig)

    cfg = Config()
    cfg.image_model = ImageModelConfig(**cell.config["ImageModel"])
    cfg.hyperparameters = HyperparametersConfig(
        **cell.config["Hyperparameters"])
    cfg.tpu = TPUConfig(**cell.traffic["TPU"])
    return cfg


def datasets(cohort: dict, multimodal: bool):
    from mmnn_sts_torch.data.loader import DeviceDataset

    out = {}
    for name, split in cohort.items():
        n = split["image"].shape[0]
        feats = {"image": split["image"]}
        if multimodal:
            feats["clinical"] = split["clinical"]
        out[name] = DeviceDataset(uids=np.arange(n), inputs=feats,
                                  events=split["events"],
                                  durations=split["durations"])
    return out["train"], out["val"]


def _graph_bodies(state) -> list:
    from mmnn_sts_torch.train.graphs import BoundBody, EpochSteps

    bodies = []
    for entry in state.graphs.values():
        if isinstance(entry, EpochSteps):
            bodies.extend(entry.graphs.values())
        elif isinstance(entry, BoundBody):
            bodies.append(entry)
    return bodies


def _captures(state) -> tuple[float, int]:
    bodies = _graph_bodies(state)
    return (sum(b.capture_seconds for b in bodies),
            sum(b.binds for b in bodies) + sum(
                b.graph is not None for b in bodies))


def _drain_npz_writers():
    from mmnn_sts_torch.train.checkpoint import AsyncNpzSaver

    for obj in gc.get_objects():
        if type(obj) is AsyncNpzSaver:
            obj.close()


def run_program(cell, seed: int, seconds: float, trace: bool, device,
                started: float) -> ProgramRun:
    """Set up, warm up, time the window and (with ``trace``) profile one
    epoch; see the module docstring."""
    from mmnn_sts_torch.constants import SUPER_BATCH_SIZE
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.models.registry import npz_layout
    from mmnn_sts_torch.parallel.mesh import make_mesh, settle_space
    from mmnn_sts_torch.train import loop
    from mmnn_sts_torch.train.schedule import make_optimizer, steps_per_epoch
    from mmnn_sts_torch.train.state import create_train_state

    seeds = inputs.split_seed(seed)
    model_cfg, traffic = cell.config["model"], cell.traffic
    if traffic["super_batch"] != SUPER_BATCH_SIZE:
        raise ValueError(f"the program's super-batch is {SUPER_BATCH_SIZE}, "
                         f"the traffic's {traffic['super_batch']}")
    flags = cell.config["flags"]
    spatial = tuple(cell.config["ImageModel"]["spatial_size"])
    cfg = program_config(cell)
    hp = cfg.hyperparameters
    hp.seed = seeds["loop"]

    weights = inputs.make_weights(cell, seeds["weights"], device)
    cohort = inputs.make_cohort(cell, seeds["cohort"], device)
    multimodal = flags["preop"]
    train_ds, val_ds = datasets(cohort, multimodal)
    ranks = settle_space(make_mesh(cfg.tpu.mesh_shape,
                                   tuple(cfg.tpu.mesh_axes)), spatial[0])
    with torch.device("meta"):
        model = build_model(cfg, True, flags["preop"], False, flags["blend"],
                            num_tabular_inputs=model_cfg.get(
                                "clinical_inputs"))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    del weights
    spe = steps_per_epoch(train_ds.num_samples, SUPER_BATCH_SIZE)
    optimizer, schedule = make_optimizer(
        model.parameters(), hp.learning_rate, spe, hp.epochs, hp.momentum,
        hp.weight_decay)
    state = create_train_state(model, optimizer, schedule, seed=hp.seed,
                               mesh=ranks)
    out_dir = tempfile.mkdtemp(prefix="perfbench-")
    loop_cfg = loop.LoopConfig(
        epochs=hp.epochs, batch_size=hp.train_batch_size,
        blend=flags["blend"], blend_update_interval=traffic[
            "blend_update_interval"], seed=hp.seed, output_dir=out_dir,
        save_params_name="best_surv_model.npz", ties=hp.cox_ties,
        eval_chunk=cfg.tpu.eval_chunk_size, fused_epoch=cfg.tpu.fused_epoch,
        npz_layout=npz_layout(cfg))

    run = ProgramRun()
    names = [k for k, _ in model.named_parameters()]
    begin_step = state.begin_step

    def observed_begin_step():
        # before superstep ``state.step``: what the steps before it left
        if state.step == 1:
            run.first_momentum = {
                k: optimizer.state[p]["momentum_buffer"].detach().clone()
                for k, p in zip(names, model.parameters())}
        if state.step == run.checked_steps:
            run.params_after = {k: p.detach().clone() for k, p in
                                zip(names, model.parameters())}
            del state.begin_step  # the class's method from here on
        begin_step()

    state.begin_step = observed_begin_step
    epoch_fn = loop.survival_train_epoch
    warmup = traffic["warmup_epochs"]
    if warmup < 1:
        raise ValueError("the reference follows the warm-up epochs: at least "
                         "one is needed")
    run.followed_epochs = warmup
    calls, losses = [0], []
    marks = {}
    profiler = [None, None]

    def stop_profiler():
        if profiler[1] is not None:
            profiler[1].__exit__(None, None, None)
            profiler[0].stop()
            profiler[1] = None

    def timed_epoch(*args, **kwargs):
        now = time.perf_counter()
        e = calls[0]
        calls[0] += 1
        if e == warmup:
            marks["t0"] = now
            run.setup_s = now - started
            run.capture_s, marks["captures"] = _captures(state)
        elif e > warmup and "t1" not in marks and now - marks["t0"] >= seconds:
            marks["t1"], marks["e1"] = now, e
            if not trace:
                raise StopWindow
            profiler[0] = _start_profiler(device)
            profiler[1] = torch.profiler.record_function(
                "perfbench.profiled_epoch")
            profiler[1].__enter__()
        elif "t1" in marks:
            stop_profiler()
            raise StopWindow
        out = epoch_fn(*args, **kwargs)
        if e < warmup:
            run.step_losses.extend(out["loss"].tolist())
            run.step_preds.append(out["preds"])
            if e == warmup - 1:
                run.val_preds = out["val_preds"]
        elif "t1" not in marks:
            losses.append(out["loss"])
        return out

    loop.survival_train_epoch = timed_epoch
    try:
        loop.train_survival(state, train_ds, val_ds, loop_cfg)
        marks.setdefault("t1", time.perf_counter())
        marks.setdefault("e1", calls[0])
        stop_profiler()
    except StopWindow:
        pass
    finally:
        loop.survival_train_epoch = epoch_fn
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.peak_reserved = torch.cuda.max_memory_reserved(device)
    _drain_npz_writers()
    shutil.rmtree(out_dir, ignore_errors=True)

    run.window_epochs = marks["e1"] - warmup
    run.window_s = marks["t1"] - marks["t0"]
    run.train_volumes = run.window_epochs * train_ds.num_samples
    run.val_volumes = run.window_epochs * val_ds.num_samples
    run.supersteps = sum(int(x.numel()) for x in losses)
    run.failed_steps = sum(int((~torch.isfinite(x)).sum()) for x in losses)
    _, captures = _captures(state)
    run.captures_in_window = captures - marks["captures"]
    if profiler[0] is not None:
        run.trace = Trace.from_profiler(profiler[0],
                                        "perfbench.profiled_epoch")
        run.profiled = {"supersteps": spe,
                        "train_volumes": train_ds.num_samples,
                        "micro_batch": hp.train_batch_size,
                        "accum": SUPER_BATCH_SIZE // hp.train_batch_size,
                        "val_volumes": val_ds.num_samples}
    state.graphs.clear()
    del state, model, optimizer, train_ds, val_ds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.cohort, run.seeds, run.steps_per_epoch = cohort, seeds, spe
    return run


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof
