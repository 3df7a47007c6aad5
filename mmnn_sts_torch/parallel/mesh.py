"""The device mesh over ``torch.distributed`` ranks (counterpart of the JAX
package's parallel/mesh.py).

The JAX package runs one global program over a mesh of devices: XLA
shards each microbatch's rows over the ``data`` axis and each volume's
depth (its first spatial axis) over the ``space`` axis, inserts the halo
exchanges of the convolutions and pools and the cross-shard sums of
BatchNorm and the global pool, and replicates over the reserved ``model``
axis. The result is the one-device run's up to reduction order. Here a
device is a rank of ``torch.distributed``, one process each, at the place
of ``np.asarray(devices).reshape(shape)``: rank r sits at
``np.unravel_index(r, shape)``. Every rank runs the same program on the
same global batch (the same split, the same shuffled indices, the same
generator state), takes its own contiguous block of each microbatch's
rows (its ``data`` index) and, under ``space``, holds its own block of
each volume's depth planes (its ``space`` index; ``split_planes``: the
blocks differ by one plane at most, and a block may be empty).
``make_mesh`` builds, on every rank in the same order, the process
subgroup of each line of ranks along ``data``, along ``space`` and over
their plane; the ``model`` axis holds replicas: its ranks run the same
program and take part in no collective.

What makes the ranks one program:

* train-mode BatchNorm adds its moments over the ranks that hold the
  batch (``models/common.compute_batch_stats``), in one all-reduce;
* the convolutions and pools of a depth-sharded activation read the
  neighbours' planes first (``SpaceShard.window``: every rank gathers the
  edge planes the others need, zero or -inf at the volume's edges), and
  the global pool and Grad-CAM's channel weights sum over the ``space``
  ranks;
* the model's output rows are all-gathered over ``data`` in rank order
  before the loss, so the Cox risk sets, the stable tie order and the BCE
  sums are the whole microbatch's and every rank computes the same loss;
* random draws are global: each rank draws the whole microbatch's dropout
  uniforms (at full depth where the activation is depth-sharded) and
  augmentation parameters, and keeps its rows and planes; the training
  augmentation, depth-global, runs on the rank's rows gathered at full
  depth, which then keeps its planes (the JAX package's post-augment
  anchor, steps.py:143-152);
* after the microbatches the gradients are summed over the ranks, and each
  rank takes the same optimizer step.

**The gradient rule.** Each rank's backward gives its share of every
gradient, and the shares summed over the ranks of the step's group (its
active ``data`` and ``space`` ranks) are the one-process gradient. So:

* a tensor that n ranks of the group compute whole carries 1/n of its
  gradient on each: the loss, which every rank computes, is
  back-propagated with weight 1 / (data x space); the gather of the output
  rows over ``data``, whose exact adjoint sums the d equal incoming
  gradients and keeps this rank's rows, folds that sum into the weight
  (``_GatherRows`` keeps its rows, and the loss takes 1 / space);
* every collective's backward is its exact adjoint: an all-reduce's is an
  all-reduce (BatchNorm's moments, the global pool), a halo gather's adds
  the gradient of each borrowed plane back on the rank that lent it;
* the gradients are summed over the group (``Shard.sum_gradients``).

Replicated tensors (everything after the global pool, the clinical MLP,
a model run replicated over ``space``) thus get their gradients once, and
partial ones (every convolution's, BatchNorm's affine, the SE block's
fully connected layers, whose output scales a sharded activation) summed.

``DataShard`` and ``SpaceShard`` are a rank's view of the two axes, and
``Shard`` a step's view of both: ``step_shard`` applies the JAX loop's
rules (loop.py:659-680): a microbatch that the ``data`` axis does not
divide runs whole on every ``data`` rank, and a run whose volume depth
the ``space`` axis does not divide runs replicated over ``space``
(``settle_space`` marks the mesh so and logs it; a 2D or an image-free
model runs so too). A step runs its microbatches ``with sharded(shard)``,
where the layers read it. Under a mesh whose ``space`` axis is on, the
steps take each volume's depth slab of this rank (``input_planes``), as
the resident and streamed splits hold it (``data/loader.py``,
``data/streaming.py``).

The backend: NCCL when each rank of a host has a card of its own; gloo on
the CPU, and when ranks share a card (NCCL refuses two ranks on one
device; gloo stages CUDA tensors through the host). A collective inside a
CUDA graph needs NCCL, so ``TPU.fused_epoch`` over gloo on a card raises
(``train/graphs.py``). The space axis issues the same calls on both
backends: all-gathers and all-reduces, no point-to-point messages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import get_logger

# every collective this module issues, by kind (forward and backward; a
# graph's replays are not counted, its capture is)
counts = {"all_reduce": 0, "all_gather": 0}
# the space axis's halo exchanges (forward gathers; each backward is one
# all-reduce in ``counts``)
space_counts = {"halo": 0}

# the axes whose ranks add into one another; ``model`` holds replicas
SUM_AXES = ("data", "space")


def reset_counts():
    for table in (counts, space_counts):
        for key in table:
            table[key] = 0


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
    the process group's, None in a single process (no group).
    ``groups`` maps a tuple of axis names (``("data",)``, ``("space",)``,
    ``("data", "space")``) to this rank's process group along them;
    ``replicate_space`` marks a run whose ``space`` ranks hold replicas
    (``settle_space``)."""

    shape: tuple
    axis_names: tuple
    rank: int = 0
    backend: str | None = None
    replicate_space: bool = False
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def coords(self) -> tuple:
        """This rank's index on each axis (JAX's device order)."""
        return tuple(int(i) for i in np.unravel_index(self.rank, self.shape))

    def size(self, axis: str) -> int:
        """The size of ``axis``, 1 where the mesh has none."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's index on ``axis``, 0 where the mesh has none."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]


def axis_lines(shape, axis_names, axes) -> list[list[int]]:
    """The ranks of each line (or plane) of the mesh along ``axes``, every
    other axis fixed, in row-major order of the fixed coordinates; the
    ranks of a line in row-major order of its own."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    moving = [axis_names.index(a) for a in axes if a in axis_names]
    fixed = [i for i in range(len(shape)) if i not in moving]
    grid = ranks.transpose(fixed + moving).reshape(
        math.prod(shape[i] for i in fixed) if fixed else 1, -1)
    return [row.tolist() for row in grid]


def _sum_axis_sets(axis_names) -> list[tuple]:
    present = [a for a in SUM_AXES if a in axis_names]
    return [c for n in range(1, len(present) + 1)
            for c in itertools.combinations(present, n)]


def make_mesh(shape=None, axis_names=("data",)) -> Mesh:
    """A mesh over every rank (one, without a process group); -1 in
    ``shape`` takes the ranks the other axes leave. With a process group
    every rank builds the subgroups of the ``data`` and ``space`` lines
    and planes, in one order (a collective call of every rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = [-1] if shape is None else list(shape)
    known = math.prod(s for s in shape if s > 0)
    shape = [world // known if s == -1 else s for s in shape]
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} devices")
    shape, names = tuple(shape), tuple(axis_names[:len(shape)])
    if not dist.is_initialized():
        return Mesh(shape, names)
    rank, backend = dist.get_rank(), dist.get_backend()
    groups = {}
    for axes in _sum_axis_sets(names):
        for line in axis_lines(shape, names, axes):
            group = dist.new_group(line)
            if rank in line:
                groups[axes] = group
    if backend == "nccl":  # each communicator outside any capture
        device = torch.device("cuda", torch.cuda.current_device())
        for group in groups.values():
            dist.all_reduce(torch.zeros(1, device=device), group=group)
        torch.cuda.synchronize(device)
    return Mesh(shape, names, rank, backend, groups=groups)


def has_data_axis(mesh) -> bool:
    return mesh is not None and "data" in mesh.axis_names


def data_axis_size(mesh) -> int:
    """Size of the ``data`` axis, 1 where there is none."""
    return 1 if mesh is None else mesh.size("data")


def space_axis_size(mesh) -> int:
    """Size of the ``space`` axis, 1 where there is none (JAX
    mesh.py:104-109)."""
    return 1 if mesh is None else mesh.size("space")


def space_on(mesh) -> bool:
    """Whether the steps shard volume depth over a ``space`` axis: a
    process group, more than one ``space`` rank, not replicated."""
    return (mesh is not None and mesh.backend is not None
            and space_axis_size(mesh) > 1 and not mesh.replicate_space)


def settle_space(mesh, depth: int | None):
    """``mesh`` for a run on volumes of ``depth`` planes (None: 2D images,
    or no images): where its ``space`` axis does not divide the depth, the
    run is replicated over ``space``, as the JAX loop's ``_space_axis``
    (loop.py:671-680) decides, and this is logged."""
    sp = space_axis_size(mesh)
    if sp == 1 or mesh.replicate_space or (depth is not None
                                           and depth % sp == 0):
        return mesh
    what = ("no 3D volumes" if depth is None
            else f"a depth of {depth} planes that {sp} does not divide")
    get_logger().info(f"space axis: {sp} ranks, {what}: the run is "
                      "replicated over 'space'")
    return dataclasses.replace(mesh, replicate_space=True)


def input_planes(mesh, depth: int) -> tuple[int, int] | None:
    """This rank's ``[start, stop)`` of a split's volume depth where the
    mesh shards it, else None. A mesh settled for the depth
    (``settle_space``) shards it only where ``space`` divides it, as the
    JAX loader's ``_space_ok`` (loader.py:39-47)."""
    if not space_on(mesh):
        return None
    if depth % space_axis_size(mesh):
        raise ValueError(f"a depth of {depth} planes over "
                         f"{space_axis_size(mesh)} 'space' ranks: settle "
                         "the mesh for it first (settle_space)")
    return split_planes(depth, space_axis_size(mesh), mesh.index("space"))


def is_writer(ranks: Mesh | None = None) -> bool:
    """Whether this process writes files: rank 0 of the mesh ``ranks``, or
    of the process group where no mesh is at hand; a single process."""
    if ranks is not None:
        return ranks.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM):
    counts["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> list:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    counts["all_gather"] += 1
    dist.all_gather(parts, t, group=group)
    return parts


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the backward sums the incoming
    gradient over them too (its exact adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _GatherRows(torch.autograd.Function):
    """The ``data`` ranks' blocks concatenated in rank order along ``dim``;
    the backward returns this rank's block of the gradient: the loss on
    the gathered rows is the same on every rank, so the adjoint's sum over
    the ranks is folded into the loss's weight (the gradient rule above)."""

    @staticmethod
    def forward(ctx, x, dim, rank, group):
        parts = _all_gather(x, group, dist.get_world_size(group))
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


@dataclass(frozen=True)
class DataShard:
    """One rank's block of the ``data`` axis: ``size`` ranks, this one
    ``rank``, their process ``group``."""

    size: int
    rank: int
    group: object = field(default=None, compare=False, repr=False)

    def rows(self, x, dim: int = 0):
        """This rank's contiguous block of x's ``dim`` (None passes)."""
        if x is None:
            return None
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def gather(self, x, dim: int = 0):
        """The whole microbatch from each rank's rows (autograd: the
        gradient keeps this rank's rows)."""
        return _GatherRows.apply(x, dim, self.rank, self.group)


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
    return DataShard(size, mesh.index("data"), mesh.groups.get(("data",)))


# ---------------------------------------------------------------------------
# The space axis
# ---------------------------------------------------------------------------


def split_planes(depth: int, size: int, index: int) -> tuple[int, int]:
    """``[start, stop)`` of rank ``index``'s planes of ``depth`` over
    ``size`` ranks: the first ``depth % size`` ranks hold one plane more;
    where ``depth < size`` the last ranks hold none."""
    base, extra = divmod(depth, size)
    start = index * base + min(index, extra)
    return start, start + base + (index < extra)


def out_depth(depth: int, kernel: int, stride: int, pad: int) -> int:
    """Planes out of a window of ``kernel`` at ``stride`` over ``depth``
    planes padded by ``pad`` on each side."""
    return (depth + 2 * pad - kernel) // stride + 1


@functools.lru_cache(maxsize=None)
def window_plan(depth: int, size: int, kernel: int, stride: int, pad: int):
    """The exchange of a window (``kernel``, ``stride``, ``pad``) over a
    tensor of ``depth`` planes sharded over ``size`` ranks, its output
    sharded by ``split_planes``. Returns ``(head, tail, needs)``: every
    rank lends its first ``head`` and last ``tail`` planes, enough for
    any rank's window; ``needs[r]`` is rank r's ``[lo, hi)`` of input
    planes (global; outside ``[0, depth)`` the padding)."""
    d_out = out_depth(depth, kernel, stride, pad)
    owned = [split_planes(depth, size, r) for r in range(size)]
    head = tail = 0
    needs = []
    for r in range(size):
        o0, o1 = split_planes(d_out, size, r)
        lo = o0 * stride - pad
        hi = (o1 - 1) * stride - pad + kernel if o1 > o0 else lo
        needs.append((lo, hi))
        a, b = owned[r]
        for q in range(max(lo, 0), min(hi, depth)):
            if a <= q < b:
                continue
            j = _owner(owned, q)
            if j < r:
                tail = max(tail, owned[j][1] - q)
            else:
                head = max(head, q - owned[j][0] + 1)
    return head, tail, tuple(needs)


def _owner(owned, q: int) -> int:
    return next(j for j, (a, b) in enumerate(owned) if a <= q < b)


@functools.lru_cache(maxsize=None)
def _runs(depth: int, size: int, index: int, head: int, tail: int,
          lo: int, hi: int) -> tuple:
    """Rank ``index``'s window ``[lo, hi)`` as runs ``(kind, rank, a, b)``
    of consecutive planes from one source: ``"own"``, its planes a..b;
    ``"lent"``, positions a..b of ``rank``'s lent strip (its ``head``
    first planes, then its ``tail`` last ones); ``"fill"``, b - a planes
    of padding."""
    owned = [split_planes(depth, size, r) for r in range(size)]
    runs = []
    for q in range(lo, hi):
        if q < 0 or q >= depth:
            src = ("fill", -1, q)
        elif owned[index][0] <= q < owned[index][1]:
            src = ("own", -1, q - owned[index][0])
        else:
            j = _owner(owned, q)
            src = ("lent", j, q - owned[j][0] if j > index
                   else head + tail - (owned[j][1] - q))
        if runs and runs[-1][:2] == src[:2] and runs[-1][3] == src[2]:
            runs[-1] = runs[-1][:3] + (src[2] + 1,)
        else:
            runs.append(src + (src[2] + 1,))
    return tuple(runs)


def _strip(xl: torch.Tensor, head: int, tail: int) -> torch.Tensor:
    """The planes a rank lends (depth at dim 1 of ``xl``): its first
    ``head`` planes, zero-padded after, then its last ``tail``, zero-padded
    before, where it holds fewer."""
    n = xl.shape[1]
    h, t = xl[:, :min(head, n)], xl[:, max(n - tail, 0):]
    rest = xl.shape[2:]
    zeros = [xl.new_zeros((xl.shape[0], k) + rest)
             for k in (head - h.shape[1], tail - t.shape[1])]
    return torch.cat([h, zeros[0], zeros[1], t], 1).contiguous()


class _Window(torch.autograd.Function):
    """Planes ``[lo, hi)`` of a depth-sharded activation x (N, C, D', ...)
    of ``depth`` planes: this rank's own, the others' from one all-gather
    of every rank's lent strip, ``fill`` outside the volume. The backward
    adds each plane's gradient back where the plane lives: one all-reduce
    of the lent strips' gradients over the ``space`` ranks, this rank then
    adding its own strip's into its edge planes."""

    @staticmethod
    def forward(ctx, x, shard, depth, head, tail, lo, hi, fill):
        xl = x.movedim(1, -1)  # (N, D', *rest, C): contiguous channels-last
        parts = None
        if head + tail:
            space_counts["halo"] += 1
            parts = _all_gather(_strip(xl, head, tail), shard.group,
                                shard.size)
        runs = _runs(depth, shard.size, shard.index, head, tail, lo, hi)
        pieces = []
        for kind, j, a, b in runs:
            if kind == "own":
                pieces.append(xl[:, a:b])
            elif kind == "lent":
                pieces.append(parts[j][:, a:b])
            else:
                pieces.append(xl.new_full((xl.shape[0], b - a)
                                          + xl.shape[2:], fill))
        out = (torch.cat(pieces, 1) if pieces
               else xl.new_zeros((xl.shape[0], 0) + xl.shape[2:]))
        ctx.geometry = (shard, xl.shape, head, tail, runs)
        return out.contiguous().movedim(-1, 1)

    @staticmethod
    def backward(ctx, g):
        shard, shape, head, tail, runs = ctx.geometry
        gl = g.movedim(1, -1)
        grad = gl.new_zeros(shape)
        lent = (gl.new_zeros((shard.size, shape[0], head + tail) + shape[2:])
                if head + tail else None)
        k = 0
        for kind, j, a, b in runs:
            if kind == "own":
                grad[:, a:b] = gl[:, k:k + b - a]
            elif kind == "lent":
                lent[j, :, a:b] = gl[:, k:k + b - a]
            k += b - a
        if lent is not None:
            mine = _all_reduce(lent, shard.group)[shard.index]
            d = shape[1]
            h, t = min(head, d), min(tail, d)
            grad[:, :h] += mine[:, :h]
            if t:
                grad[:, d - t:] += mine[:, head + tail - t:]
        return (grad.movedim(-1, 1), None, None, None, None, None, None,
                None)


@dataclass(frozen=True)
class SpaceShard:
    """One rank's block of the ``space`` axis: ``size`` ranks, this one
    ``index``, their process ``group``. ``depths`` maps an activation's
    local spatial shape (its planes, then the unsharded axes) to its
    global depth: seeded with the input volume's, extended by every
    sharded convolution and pool, read by the layers that need the
    global geometry. Two activations of one local shape and different
    depths would be ambiguous; ``register`` refuses that."""

    size: int
    index: int
    group: object = field(default=None, compare=False, repr=False)
    depths: dict = field(default_factory=dict, compare=False, repr=False)

    def planes(self, depth: int) -> tuple[int, int]:
        return split_planes(depth, self.size, self.index)

    def register(self, x: torch.Tensor, depth: int) -> torch.Tensor:
        """Record that x (N, C, D', ...) is this rank's block of ``depth``
        planes; returns x."""
        key = tuple(x.shape[2:])
        if self.depths.setdefault(key, depth) != depth:
            raise ValueError(f"space shard: local shape {key} is both "
                             f"{self.depths[key]} and {depth} planes deep")
        return x

    def depth_of(self, x: torch.Tensor) -> int:
        """The global depth of x (N, C, D', ...)."""
        key = tuple(x.shape[2:])
        if key not in self.depths:
            raise KeyError(f"space shard: no depth recorded for an "
                           f"activation of local shape {key}")
        return self.depths[key]

    def window(self, x, kernel: int, stride: int, pad: int,
               fill: float = 0.0):
        """What a window (``kernel``, ``stride``, ``pad``) along depth
        reads on this rank: x's planes of its output block's reach,
        ``fill`` for the padding, so that the op then runs with no depth
        padding. Returns ``(planes, depth out, this rank's planes out)``."""
        depth = self.depth_of(x)
        head, tail, needs = window_plan(depth, self.size, kernel, stride,
                                        pad)
        lo, hi = needs[self.index]
        d_out = out_depth(depth, kernel, stride, pad)
        o0, o1 = self.planes(d_out)
        start, stop = self.planes(depth)
        if not head + tail and (lo, hi) == (start, stop):
            return x, d_out, o1 - o0
        if not head + tail and start <= lo and hi <= stop and lo < hi:
            return x.narrow(2, lo - start, hi - lo), d_out, o1 - o0
        return (_Window.apply(x, self, depth, head, tail, lo, hi, fill),
                d_out, o1 - o0)

    def sum(self, x):
        """Autograd sum over the ``space`` ranks."""
        return _AllReduceSum.apply(x, self.group)

    @torch.no_grad()
    def reduce(self, x, op=dist.ReduceOp.MAX):
        """x reduced over the ``space`` ranks (no gradient)."""
        return _all_reduce(x.contiguous().clone(), self.group, op)

    @torch.no_grad()
    def gather(self, x, depth: int, dim: int):
        """The whole ``depth`` planes from every rank's block of x's
        ``dim`` (no gradient): blocks padded to the largest, gathered,
        trimmed."""
        block = -(-depth // self.size)
        n = x.shape[dim]
        if n < block:
            pad = list(x.shape)
            pad[dim] = block - n
            x = torch.cat([x, x.new_zeros(pad)], dim)
        parts = _all_gather(x, self.group, self.size)
        return torch.cat([p.narrow(dim, 0, b - a) for p, (a, b) in zip(
            parts, (split_planes(depth, self.size, r)
                    for r in range(self.size)))], dim)

    def keep(self, x, dim: int):
        """This rank's planes of x's full-depth ``dim``, as a tensor of
        their own (the full one can go)."""
        a, b = self.planes(x.shape[dim])
        return x.narrow(dim, a, b - a).clone()


def space_shard(mesh, image) -> SpaceShard | None:
    """This rank's ``space`` shard of an image microbatch (B, D', H, W, C),
    this rank's depth slab, or None: where the mesh's ``space`` axis is
    on and the image is a batch of 3D volumes. The shard records the
    input's global depth, D' x the axis's size."""
    if not space_on(mesh) or image is None or image.dim() != 5:
        return None
    size = space_axis_size(mesh)
    shard = SpaceShard(size, mesh.index("space"), mesh.groups.get(("space",)))
    depth = image.shape[1] * size
    shard.depths[(image.shape[1],) + tuple(image.shape[2:4])] = depth
    return shard


@dataclass(frozen=True)
class Shard:
    """A step's view of the mesh: this rank's rows (``data``, or None where
    every rank takes the whole microbatch), its planes (``space``, or
    None where volumes are whole), and the ``group`` of the ``size`` ranks
    that add into one another."""

    data: DataShard | None
    space: SpaceShard | None
    group: object = field(default=None, compare=False, repr=False)
    size: int = 1

    @property
    def row_ranks(self) -> int:
        return 1 if self.data is None else self.data.size

    def rows(self, x, dim: int = 0):
        """This rank's rows of x (all of them without a ``data`` shard)."""
        return x if self.data is None else self.data.rows(x, dim)

    def holding(self, x):
        """The shard of the ranks holding blocks of x (N, C, ...): all of
        them where x is a depth-sharded volume activation, else the
        ``data`` ranks (None without), x being whole on every ``space``
        rank."""
        if self.space is None or x.dim() == 5:
            return self
        if self.data is None:
            return None
        return Shard(self.data, None, self.data.group, self.data.size)

    def gather(self, x, dim: int = 0):
        return x if self.data is None else self.data.gather(x, dim)

    def all_reduce(self, x):
        """Autograd sum over the group."""
        return _AllReduceSum.apply(x, self.group)

    def backward(self, loss):
        """Back-propagate the loss every rank computes, with the weight of
        the gradient rule (1 / the ``space`` ranks; the ``data`` gather
        folds in the rest)."""
        if self.space is None:
            loss.backward()
        else:
            (loss * (1.0 / self.space.size)).backward()

    @torch.no_grad()
    def sum_gradients(self, grads):
        """Sum ``grads`` over the group in place, in one collective."""
        if not grads:
            return
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           self.group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view(g.shape))


def step_shard(mesh, rows: int | None = None, image=None) -> Shard | None:
    """A step's ``Shard`` of a microbatch of ``rows`` rows whose image
    leaf is ``image`` (B, ...), this rank's slab where the ``space`` axis
    is on; None where neither axis shards it."""
    data = data_shard(mesh, rows)
    space = space_shard(mesh, image)
    if data is None and space is None:
        return None
    axes = tuple(a for a, s in (("data", data), ("space", space))
                 if s is not None)
    size = math.prod(mesh.size(a) for a in axes)
    return Shard(data, space, mesh.groups.get(axes), size)


def space_only(mesh, image) -> Shard | None:
    """The ``Shard`` of a batch that every ``data`` rank takes whole (a
    Grad-CAM batch of one) over the mesh's ``space`` axis, or None."""
    space = space_shard(mesh, image)
    return None if space is None else Shard(None, space, space.group,
                                            space.size)


_active: Shard | None = None


@contextlib.contextmanager
def sharded(shard: Shard | None):
    """Within: the layers (BatchNorm's statistics, the convolutions and
    pools, dropout) and the augmentation read ``shard`` as the layout of
    their batch."""
    global _active
    before, _active = _active, shard
    try:
        yield
    finally:
        _active = before


def active_shard() -> Shard | None:
    return _active


def active_space() -> SpaceShard | None:
    return None if _active is None else _active.space
