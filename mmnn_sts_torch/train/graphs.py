"""CUDA graphs of the training steps: ``TPU.fused_epoch`` on the card.

The JAX package runs a fused epoch as one XLA program (train/steps.py:
341-429, 528-592), so the host pays one dispatch an epoch. The eager port
pays one launch a kernel, 70,000-83,000 a flagship superstep, and the host
paces the step. Here each step body is captured once as a CUDA graph and
replayed once a step: one graph for the full superstep (or classification
step), one for the ragged tail with its mask, one for the fused validation
forward.

What a graph reads stays where it was at the capture:

* the batch is gathered from the resident split through a device index
  buffer, filled before each replay from pinned host memory (a ring of
  two, each reused only after its copy has run);
* the tail's mask, the step's output slot and the epoch's output buffers
  (the step's loss and predictions are written into row ``slot``) are
  buffers of their own;
* the gradients, the momentum buffers, the rate table and the step
  counter are the train state's (``train/state.py``); the blend weights
  are the tensors of ``state.blend`` at the bind, which the loop updates
  in place (``ops/blending.assign_blend``).

Each run first checks the addresses of everything the body reads. Where one
changed (a checkpoint restore replaces the momentum buffers; a grown rate
table; a replaced ``BlendState``) the body is bound and captured again;
``binds`` counts these, so a run that replaces a tensor shows it.

On a CUDA device the first run of a body is eager, on the capture stream:
the warm-up is the step's real work, and cuDNN, cuBLAS and the allocator
meet every shape there first. The second run captures (nothing executes)
and replays; later runs replay. The state's generator is registered with
every graph, so each replay draws fresh bits in eager order. A capture
that fails raises ``GraphCaptureError`` naming the operation; nothing
falls back to eager. Python's cyclic collector is off during a capture: a
finished run's state is a reference cycle that holds its graphs, and a
graph destroyed while another is captured invalidates that capture (CUDA:
"operation not permitted when stream is capturing"), which then fails at
whatever operation the capture reaches next. On the CPU, which only tests
ask for, every run calls the bound body eagerly over the same buffers.

The fused bottleneck kernel's wrapper counts its launches when the body
calls it: at the warm-up and at the capture, not at a replay.
``launches_per_capture`` keeps the count of the capture, ``replays`` the
replays.

Each body stamps its phases on the device (``utils/tracing.py``): the step
and tail bodies into a row of the epoch's ``PhaseRows`` at the slot of the
index buffer (``gather``, then the phases ``train/steps.py`` marks), the
validation forward into a row of its own (``val_forward``). The stamps are
kernels of the body, so a replay writes them as the warm-up did.

Under a mesh of ranks (``parallel/mesh.py``) the step's collectives (the
BatchNorm sums, the output gather, the gradient sum; under ``space`` the
halo exchanges, the global pool's sums and the augmentation's depth
gather, each a fixed-shape all-gather or all-reduce planned on the host)
are captured inside the graphs over NCCL, whose communicators are built
before the first capture (``mesh.maybe_initialize_distributed``,
``mesh.make_mesh``). A gloo collective stages
CUDA tensors through the host, which no capture can hold: over gloo on a
card the graphs raise ``ConfigurationError`` at their first use, and
nothing runs eagerly in their place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import time
import traceback

import torch

from ..exceptions import ConfigurationError
from ..ops import fused_dense
from ..utils import tracing


class GraphCaptureError(RuntimeError):
    """A step body could not be captured as a CUDA graph."""


def _failed_op(err: BaseException) -> str:
    """Where the capture broke: the innermost frame outside torch and this
    module in the first error raised (a failed capture also fails its end,
    whose error carries the first as its context)."""
    root = err
    while root.__context__ is not None:
        root = root.__context__
    frames = traceback.extract_tb(root.__traceback__)
    torch_dir = os.path.dirname(torch.__file__)
    ours = [f for f in frames if not f.filename.startswith(torch_dir)
            and f.filename != __file__]
    f = (ours or frames)[-1]
    return (f"{f.filename}:{f.lineno} in {f.name}: {f.line!r} "
            f"({type(root).__name__}: {root})")


@contextlib.contextmanager
def no_collection():
    """Python's cyclic collector off within, and as it was on exit: no dead
    graph is destroyed by a collection that falls inside a capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class BoundBody:
    """A step body over fixed buffers (see the module docstring).

    ``bind()`` returns the body, a callable of ``warm`` (True on the
    warm-up run) that reads the tensors as they are at the bind; ``reads()``
    lists every tensor the body reads or writes, whose addresses decide
    when to bind and capture again."""

    def __init__(self, name: str, state, bind, reads):
        self.name = name
        self.state = state
        self.bind = bind
        self.reads = reads
        self.body = None
        self.signature = None
        self.graph = None
        self.outputs = None
        self.warm = False
        self.binds = 0
        self.replays = 0
        self.launches_per_capture = None
        self.capture_seconds = 0.0
        self.last = None
        self.stream = None  # the warm-up's and the capture's
        self.rows = None  # the PhaseRows it stamps, where it has its own

    @property
    def settled(self) -> bool:
        """Whether a run replays its graph (on the CPU: runs its bound
        body) without a warm-up or a capture first."""
        if self.state.device.type == "cuda":
            return self.graph is not None
        return self.body is not None

    def _signature(self) -> tuple:
        return (id(self.state.generator),) + tuple(
            t.data_ptr() for t in self.reads())

    def run(self):
        """Run the body once: eagerly (the CPU, or the warm-up on the
        card), or as a replay of its graph, captured first where needed.
        ``last`` says which: "eager", "warm-up" or "replay"."""
        signature = self._signature()
        if signature != self.signature:
            self.body, self.signature = self.bind(), signature
            self.graph, self.warm = None, False
            self.binds += 1
        device = self.state.device
        if device.type != "cuda":
            self.last = "eager"
            return self.body(warm=False)
        current = torch.cuda.current_stream(device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        side = self.stream
        if not self.warm:
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self.body(warm=True)
            current.wait_stream(side)
            self.warm, self.last = True, "warm-up"
            return out
        if self.graph is None:
            self._capture(side)
        self.graph.replay()
        self.replays += 1
        self.last = "replay"
        return self.outputs

    def _capture(self, stream):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.generator)
        launches = fused_dense.fused_bn_relu_matmul.launches
        t0 = time.perf_counter()
        try:
            # thread_local: work of other threads (the best-model writer's
            # device-to-host copies on its own stream) may run meanwhile;
            # a host sync in this thread still fails the capture
            with no_collection(), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                outputs = self.body(warm=False)
        except Exception as err:  # noqa: BLE001 - raised again, named
            raise GraphCaptureError(
                f"capturing the {self.name} graph failed at "
                f"{_failed_op(err)}") from err
        self.capture_seconds += time.perf_counter() - t0
        self.launches_per_capture = (
            fused_dense.fused_bn_relu_matmul.launches - launches)
        self.graph, self.outputs = graph, outputs


def _model_tensors(state) -> list[torch.Tensor]:
    model = state.model
    return (list(model.parameters()) + list(model.buffers())
            + [state.blend.weights])


class EpochSteps:
    """The step and tail bodies of one epoch shape over one resident
    split, with their shared buffers: the index buffer (slot, then the
    flat indices), the tail's mask, the epoch's loss and prediction rows,
    and its rows of phase stamps (``rows``, ``width`` stamps a row)."""

    def __init__(self, state, ds, names, shape, steps, body, width):
        device = state.device
        n = math.prod(shape)
        pin = device.type == "cuda"
        self.state, self.ds, self.names = state, ds, names
        self.shape, self.steps, self.body = tuple(shape), steps, body
        self.host = [torch.empty(n + 1, dtype=torch.int64, pin_memory=pin)
                     for _ in range(2)]
        self.copied = [None, None]
        self.turn = 0
        self.index = torch.empty(n + 1, dtype=torch.int64, device=device)
        self.mask = torch.ones(shape, device=device)
        self.loss = torch.zeros(steps, device=device)
        self.preds = None
        self.rows = tracing.PhaseRows(steps, device, width)
        self.stampers = {kind: tracing.Stamper(kind, self.rows,
                                               self.index[:1])
                         for kind in ("step", "tail")}
        self.graphs = {kind: BoundBody(f"{kind} step", state,
                                       lambda kind=kind: self._bind(kind),
                                       lambda kind=kind: self._reads(kind))
                       for kind in ("step", "tail")}

    def _reads(self, kind) -> list[torch.Tensor]:
        state = self.state
        inputs = self.ds.model_inputs()
        tensors = (list(inputs.values()) if isinstance(inputs, dict)
                   else [inputs])
        tensors += [getattr(self.ds, n) for n in self.names]
        tensors += _model_tensors(state) + state.gradients() \
            + state.momentum_buffers()
        tensors += [state.rates, state.step_t, self.index]
        if kind == "tail":
            tensors.append(self.mask)
        return tensors

    def _bind(self, kind):
        state, ds, shape = self.state, self.ds, self.shape
        blend_state = dataclasses.replace(state.blend)
        inputs = ds.model_inputs()
        targets = {n: getattr(ds, n) for n in self.names}
        mask = self.mask if kind == "tail" else None
        stamper = self.stampers[kind]

        def body(warm: bool):
            slot, flat = self.index[:1], self.index[1:]

            def take(x):
                return x.index_select(0, flat).view(shape + x.shape[1:])

            with stamper:
                batch = {"inputs": ({k: take(v) for k, v in inputs.items()}
                                    if isinstance(inputs, dict)
                                    else take(inputs))}
                batch.update({n: take(t) for n, t in targets.items()})
                tracing.mark("gather")
                aux = self.body(state, blend_state, batch, mask)
            if not warm and self.preds is not None:
                self.loss.index_copy_(0, slot, aux["loss"].view(1))
                self.preds.index_copy_(0, slot, aux["preds"].unsqueeze(0))
            return aux

        return body

    def _load(self, idx, slot: int, mask):
        """Stage one step's slot and indices (and the tail's mask) into the
        device buffers, on the current stream."""
        host = self.host[self.turn]
        if self.copied[self.turn] is not None:
            self.copied[self.turn].synchronize()
        host[0] = slot
        host[1:] = torch.as_tensor(idx).reshape(-1)
        self.index.copy_(host, non_blocking=True)
        if self.index.is_cuda:
            self.copied[self.turn] = torch.cuda.Event()
            self.copied[self.turn].record()
        self.turn ^= 1
        if mask is not None:
            self.mask.copy_(torch.as_tensor(mask))

    def run(self, kind: str, idx, slot: int, mask=None) -> dict:
        """Run step ``slot`` of the epoch (``kind`` "step" or "tail") on
        the batch ``idx``; returns the epoch's loss and prediction rows."""
        self._load(idx, slot, mask)
        self.rows.writers[slot] = self.stampers[kind]
        graph = self.graphs[kind]
        had_rows = self.preds is not None
        out = graph.run()
        if graph.last == "warm-up" or not had_rows:
            # a run whose body wrote no rows: its outputs go in here
            if self.preds is None:
                self.preds = torch.zeros((self.steps,) + out["preds"].shape,
                                         dtype=out["preds"].dtype,
                                         device=self.loss.device)
            self.loss[slot].copy_(out["loss"])
            self.preds[slot].copy_(out["preds"])
        return {"loss": self.loss, "preds": self.preds}


def _check_capturable(state):
    """Raise where the step's collectives cannot be captured: gloo ranks on
    a card."""
    ranks = state.mesh
    if (state.device.type == "cuda" and ranks is not None
            and ranks.backend == "gloo"):
        raise ConfigurationError(
            "TPU.fused_epoch captures each step as a CUDA graph, and a "
            "graph cannot hold a gloo collective (gloo stages CUDA tensors "
            "through the host); run one rank per card, over NCCL, or turn "
            "TPU.fused_epoch off")


def epoch_steps(state, key, ds, names, shape, steps, body,
                width) -> EpochSteps:
    """The cached ``EpochSteps`` of ``key`` on ``state``, made at first
    use."""
    _check_capturable(state)
    if key not in state.graphs:
        state.graphs[key] = EpochSteps(state, ds, names, shape, steps, body,
                                       width)
    return state.graphs[key]


def forward_graph(state, key, forward, reads) -> BoundBody:
    """The cached bound validation forward of ``key``: ``forward(blend_state)``
    returns a dict of tensors; ``reads()`` lists the split's tensors. Its
    body stamps ``val_forward`` into the one row of its ``rows``."""
    _check_capturable(state)
    if key not in state.graphs:
        rows = tracing.PhaseRows(1, state.device, 2)
        stamper = rows.at(0, "val")

        def bind():
            blend_state = dataclasses.replace(state.blend)

            def body(warm: bool):
                with stamper:
                    out = forward(blend_state)
                    tracing.mark("val_forward")
                return out

            return body

        graph = BoundBody("validation forward", state, bind,
                          lambda: _model_tensors(state) + list(reads()))
        graph.rows = rows
        state.graphs[key] = graph
    return state.graphs[key]


def bodies(state) -> list[BoundBody]:
    """Every bound body of ``state``: each epoch shape's step and tail, and
    the validation forwards."""
    out = []
    for entry in state.graphs.values():
        out.extend(entry.graphs.values() if isinstance(entry, EpochSteps)
                   else [entry])
    return out
