"""The device mesh over ``torch.distributed`` ranks (counterpart of the JAX
package's parallel/mesh.py).

The JAX package runs one global program over a mesh of devices; XLA
shards each microbatch's rows over the ``data`` axis, and the result is
the one-device run's up to reduction order. Here a device is a rank of
``torch.distributed``, one process each, and every rank runs the same
program on the same global batch (the same split, the same shuffled
indices, the same generator state), taking its own contiguous block of
each microbatch's rows. What makes the ranks one program:

* train-mode BatchNorm sums ``(sum x, sum x^2, n_valid)`` over the ranks
  before its one-pass formula (``models/common.compute_batch_stats``), in
  one all-reduce whose backward all-reduces the incoming gradient;
* the model's output rows are all-gathered in rank order before the loss,
  so the Cox risk sets, the stable tie order and the BCE sums are the whole
  microbatch's, and every rank computes the same loss; the gather's
  backward keeps this rank's slice of the gradient (an autograd all-gather
  that summed it over the ranks would scale every gradient by the world);
* random draws are global: each rank draws the whole microbatch's dropout
  uniforms and augmentation parameters and keeps its rows;
* after the microbatches the gradients are summed over the ranks, and each
  rank takes the same optimizer step.

``DataShard`` is a rank's view of the ``data`` axis; ``data_shard`` applies
the JAX loop's rule (loop.py:659-668): a microbatch that the axis does not
divide runs whole on every rank, with no collective. A training step runs
its microbatches ``with sharded(shard)``, where the layers read it.

The backend: NCCL when each rank of a host has a card of its own; gloo on
the CPU, and when ranks share a card (NCCL refuses two ranks on one
device; gloo stages CUDA tensors through the host). A collective inside a
CUDA graph needs NCCL, so ``TPU.fused_epoch`` over gloo on a card raises
(``train/graphs.py``).

The ``space`` axis and a ``model`` axis of more than one device are not
ported (``config.validate_config`` refuses them; ROADMAP.md Queue 1).
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

# every collective this module issues, by kind (forward and backward; a
# graph's replays are not counted, its capture is)
counts = {"all_reduce": 0, "all_gather": 0}


def reset_counts():
    for key in counts:
        counts[key] = 0


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when ``device`` is a card and each of this host's
    ``local_world`` ranks has one of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` becomes ``cuda:LOCAL_RANK`` (modulo the
    cards there are, so ranks may share one); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def maybe_initialize_distributed(device="cpu",
                                 init_method: str = "env://") -> bool:
    """Initialise the process group from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; ``MASTER_ADDR`` and ``MASTER_PORT`` for the
    default ``env://``), with the backend ``choose_backend`` gives for this
    rank's device. Does nothing without that environment, as the JAX
    package's does nothing without its coordinator's (mesh.py:33-51).
    Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    device = rank_device(device)
    backend = choose_backend(device,
                             int(env.get("LOCAL_WORLD_SIZE", world)))
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    if backend == "nccl":
        # NCCL builds its communicator at the first collective, which must
        # not fall inside a CUDA graph's capture
        dist.all_reduce(torch.zeros(1, device=device))
        torch.cuda.synchronize(device)
    get_logger().info(f"distributed: rank {rank} of {world}, backend "
                      f"{backend}, device {device}")
    return True


@dataclass(frozen=True)
class Mesh:
    """The ranks as a mesh of ``shape`` over ``axis_names``; ``backend`` is
    the process group's, None in a single process (no group)."""

    shape: tuple
    axis_names: tuple
    rank: int = 0
    backend: str | None = None


def make_mesh(shape=None, axis_names=("data",)) -> Mesh:
    """A mesh over every rank (one, without a process group); -1 in
    ``shape`` takes the ranks the other axes leave."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = [-1] if shape is None else list(shape)
    known = math.prod(s for s in shape if s > 0)
    shape = [world // known if s == -1 else s for s in shape]
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} devices")
    if not dist.is_initialized():
        return Mesh(tuple(shape), tuple(axis_names[:len(shape)]))
    return Mesh(tuple(shape), tuple(axis_names[:len(shape)]),
                dist.get_rank(), dist.get_backend())


def has_data_axis(mesh) -> bool:
    return mesh is not None and "data" in mesh.axis_names


def data_axis_size(mesh) -> int:
    """Size of the ``data`` axis, 1 where there is none."""
    if not has_data_axis(mesh):
        return 1
    return mesh.shape[mesh.axis_names.index("data")]


def is_writer(ranks: Mesh | None = None) -> bool:
    """Whether this process writes files: rank 0 of the mesh ``ranks``, or
    of the process group where no mesh is at hand; a single process."""
    if ranks is not None:
        return ranks.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    counts["all_reduce"] += 1
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over the
    ranks too (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format))


class _GatherRows(torch.autograd.Function):
    """The ranks' blocks concatenated in rank order along ``dim``; the
    backward returns this rank's block of the gradient (the loss on the
    gathered rows is the same on every rank, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, dim, rank, size):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        counts["all_gather"] += 1
        dist.all_gather(parts, x)
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


@dataclass(frozen=True)
class DataShard:
    """One rank's block of the ``data`` axis: ``size`` ranks, this one
    ``rank``."""

    size: int
    rank: int

    def rows(self, x, dim: int = 0):
        """This rank's contiguous block of x's ``dim`` (None passes)."""
        if x is None:
            return None
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def all_reduce(self, x):
        """Autograd sum over the ranks."""
        return _AllReduceSum.apply(x)

    def gather(self, x, dim: int = 0):
        """The whole microbatch from each rank's rows (autograd: the
        gradient keeps this rank's rows)."""
        return _GatherRows.apply(x, dim, self.rank, self.size)

    @torch.no_grad()
    def sum_gradients(self, grads):
        """Sum ``grads`` over the ranks in place, in one collective."""
        if not grads:
            return
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view(g.shape))


def data_shard(mesh, rows: int | None = None) -> DataShard | None:
    """This rank's shard of a microbatch of ``rows`` rows, or None: the
    JAX loop's ``_data_axis`` rule, where a process group is up and the
    mesh has a ``data`` axis that divides ``rows`` (None: any rows, for a
    split evaluated with a padded last block)."""
    if not (has_data_axis(mesh) and mesh.backend is not None):
        return None
    size = data_axis_size(mesh)
    if rows is not None and rows % size:
        return None
    return DataShard(size, mesh.rank % size)


_active: DataShard | None = None


@contextlib.contextmanager
def sharded(shard: DataShard | None):
    """Within: the layers (BatchNorm's statistics, dropout) and the
    augmentation read ``shard`` as the data axis of their batch."""
    global _active
    before, _active = _active, shard
    try:
        yield
    finally:
        _active = before


def active_shard() -> DataShard | None:
    return _active
