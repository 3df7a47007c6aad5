"""The port's ``space`` axis (``parallel/mesh.py``): volume depth sharded
over ranks, with halo exchanges.

In process: the sharded primitives of ``models/common.py`` at every
geometry the models use, each rank a thread of this process holding its
block of planes of one tensor (``split_planes``), the collectives an
exchange between the threads (``Ranks``). Each is held against the
unsharded op on the whole tensor: the ranks' outputs and input gradients
concatenated, their parameter gradients summed, within 1e-6 in relative
L2 (the convolutions in float64: a parameter gradient adds thousands of
products, whose float32 reassociation alone reaches 1e-6; the pools in
float32), or for bfloat16 against the rounding control of the same op in
float32. Also: ``compute_batch_stats`` over uneven and empty
blocks (and the planted equal-weight mean it must not be), the rank
order of the mesh against JAX's ``make_mesh`` on its 8 virtual devices,
and the config's mesh settings.

The ranks as processes: a module fixture spawns 4 gloo CPU ranks of
``tests/test_torch_space_ranks.py`` once (jax, flax, pandas, matplotlib
and yaml blocked there) and holds their cases (see that file's
docstring) against the one-process port, and each case without a random
draw (all but the augmented, dropout-drawing ``pair`` and R3D-18, and
``replicas``, whose 3 rows JAX cannot place on a 2-device ``data`` axis)
against the JAX package on a mesh of the same shape on its virtual
devices. Two of JAX's meshes are not its one-device run; those cases are
held against the mesh that is (``JAX_MESHES``).
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_space_ranks as ranks_prog
from mmnn_sts_torch.models import common
from mmnn_sts_torch.parallel import mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LIMIT = 1e-6


class Ranks:
    """``size`` ranks of one ``space`` axis as threads of this process: the
    module's collectives become an exchange between them, each thread
    reads its own shard."""

    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots = [None] * size
        self.local = threading.local()

    def exchange(self, t):
        r = self.local.index
        self.slots[r] = t.detach().clone()
        self.barrier.wait()
        out = [s.clone() for s in self.slots]
        self.barrier.wait()
        return out

    def all_gather(self, t, group, size):
        return self.exchange(t.contiguous())

    def all_reduce(self, t, group=None, op=torch.distributed.ReduceOp.SUM):
        parts = self.exchange(t)
        total = parts[0]
        for p in parts[1:]:
            total = (torch.maximum(total, p)
                     if op == torch.distributed.ReduceOp.MAX else total + p)
        t.copy_(total)
        return t

    def run(self, fn, monkeypatch):
        """``fn(shard)`` on every rank (a ``SpaceShard``); returns the
        results in rank order."""
        monkeypatch.setattr(mesh, "_all_gather", self.all_gather)
        monkeypatch.setattr(mesh, "_all_reduce", self.all_reduce)
        monkeypatch.setattr(mesh, "active_shard",
                            lambda: getattr(self.local, "shard", None))
        monkeypatch.setattr(mesh, "active_space",
                            lambda: getattr(self.local, "space", None))
        out, errors = [None] * self.size, []

        def rank(r):
            self.local.index = r
            space = mesh.SpaceShard(self.size, r)
            self.local.space = space
            self.local.shard = mesh.Shard(None, space, None, self.size)
            try:
                out[r] = fn(space)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(want.norm(), 1e-30))


def block(x, space, depth, dim=2):
    a, b = space.planes(depth)
    return x.narrow(dim, a, b - a)


def sharded_run(op, x, g, params, size, monkeypatch):
    """(output, input gradient, parameter gradients) of ``op`` on x
    (N, C, D, H, W) sharded over ``size`` thread ranks, the upstream
    gradient g's blocks fed to each; outputs and input gradients
    concatenated over the ranks, parameter gradients summed."""
    depth = x.shape[2]
    results = Ranks(size).run(lambda space: _rank_run(
        op, x, g, params, space, depth), monkeypatch)
    outs = torch.cat([r[0] for r in results], 2)
    grads = torch.cat([r[1] for r in results], 2)
    pgrads = [sum(r[2][i] for r in results) for i in range(len(params))]
    return outs, grads, pgrads


def _rank_run(op, x, g, params, space, depth):
    local = block(x, space, depth).detach().clone().requires_grad_()
    space.register(local, depth)
    out = op(common.channels_last(local))
    pg = torch.autograd.grad(
        out, [local] + list(params),
        block(g, space, space.depth_of(out)).to(out.dtype),
        allow_unused=True)
    return (out.detach(), pg[0],
            [torch.zeros_like(p) if q is None else q
             for p, q in zip(params, pg[1:])])


def out_shape(op, x):
    with torch.no_grad():
        return tuple(op(common.channels_last(x)).shape)


def whole_run(op, x, g, params):
    x = x.detach().clone().requires_grad_()
    out = op(common.channels_last(x))
    pg = torch.autograd.grad(out, [x] + list(params), g.to(out.dtype),
                             allow_unused=True)
    return out.detach(), pg[0], [torch.zeros_like(p) if q is None else q
                                 for p, q in zip(params, pg[1:])]


def conv_case(kernel, stride, padding, channels=(3, 5)):
    torch.manual_seed(0)
    c = common.conv(channels[0], channels[1], kernel, stride=stride,
                    padding=padding, use_bias=True).double()
    with torch.no_grad():
        c.bias.normal_()
    return c


# (name, kernel, stride, padding, depth, ranks): every geometry of the
# models' convolutions, at depths whose blocks are even, uneven and empty
CONVS = [
    ("k3 p1", 3, 1, 1, 16, 2),
    ("k3 p1 uneven", 3, 1, 1, 10, 4),
    ("k3 p1 depth below ranks", 3, 1, 1, 3, 4),
    ("stem 7 s2 p3", 7, 2, 3, 16, 2),
    ("stem 7 s2 p3 uneven", 7, 2, 3, 14, 4),
    ("strided 3 s2 p1", 3, 2, 1, 12, 4),
    ("strided 1 s2", 1, 2, "SAME", 10, 4),
    ("1x1x1", 1, 1, "SAME", 9, 4),
    ("VALID 3", 3, 1, "VALID", 16, 4),
    ("VALID 3 to empty blocks", 3, 1, "VALID", 5, 4),
    ("r3d stem (1,7,7) s(1,2,2) p(1,3,3)", (1, 7, 7), (1, 2, 2), (1, 3, 3),
     6, 4),
]


@pytest.mark.parametrize("name,kernel,stride,padding,depth,size", CONVS,
                         ids=[c[0] for c in CONVS])
def test_sharded_conv_equals_the_whole_conv(name, kernel, stride, padding,
                                            depth, size, monkeypatch):
    c = conv_case(kernel, stride, padding)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, depth, 9, 8)))
    params = [c.weight, c.bias]
    g = torch.from_numpy(rng.normal(size=out_shape(c, x)))
    want = whole_run(c, x, g, params)
    got = sharded_run(c, x, g, params, size, monkeypatch)
    assert got[0].shape == want[0].shape
    errs = [rel_l2(got[0], want[0]), rel_l2(got[1], want[1])] + [
        rel_l2(a, b) for a, b in zip(got[2], want[2])]
    assert max(errs) <= LIMIT, (name, errs)


POOLS = [("max 3 s2 p1", "max", 16, 2), ("max 3 s2 p1 uneven", "max", 10, 4),
         ("max to empty blocks", "max", 5, 4), ("avg 2 s2", "avg", 16, 2),
         ("avg 2 s2 uneven", "avg", 10, 4),
         ("avg to empty blocks", "avg", 3, 4)]


def pool_op(kind):
    if kind == "max":
        return lambda x: common.max_pool(x, 3, 2, 1)
    return lambda x: common.avg_pool(x, 2, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kind,depth,size", POOLS,
                         ids=[p[0] for p in POOLS])
def test_sharded_pools_equal_the_whole_pools(name, kind, depth, size, dtype,
                                             monkeypatch):
    """float32 within 1e-6; bfloat16's forward bit for bit where the op
    rounds as the whole one does (max and the running-sum average), and
    everything within the float32 op's distance from the bfloat16 one
    (its rounding control)."""
    op = pool_op(kind)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 4, depth, 6, 6))
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=out_shape(op, x)).astype(np.float32))
    if dtype == "float32":
        want = whole_run(op, x, g, [])
        got = sharded_run(op, x, g, [], size, monkeypatch)
        errs = [rel_l2(got[0], want[0]), rel_l2(got[1], want[1])]
        assert max(errs) <= LIMIT, (name, errs)
        return
    xb = x.bfloat16().float()
    want32 = whole_run(op, xb, g, [])
    want = whole_run(op, xb.bfloat16(), g.bfloat16(), [])
    got = sharded_run(op, xb.bfloat16(), g.bfloat16(), [], size, monkeypatch)
    if kind != "global":
        assert torch.equal(got[0], want[0]), name
    for i in (0, 1):
        control = rel_l2(want[i].float(), want32[i])
        assert rel_l2(got[i].float(), want[i].float()) <= max(
            control, 1e-30), (name, i, control)


@pytest.mark.parametrize("depth,size", [(10, 4), (3, 4), (8, 2)])
def test_sharded_global_pool_equals_the_whole_pool(depth, size, monkeypatch):
    """The pool of every rank equals the whole one; under the gradient
    rule each rank back-propagates 1 / the ranks of the replicated
    output's gradient, and the ranks' input gradients are the whole
    pool's."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 4, depth, 3, 5))
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
    want = whole_run(common.global_avg_pool, x, g, [])

    def rank(space):
        local = space.register(block(x, space, depth).clone()
                               .requires_grad_(), depth)
        out = common.global_avg_pool(local)
        (grad,) = torch.autograd.grad(out, local, g / size)
        return out.detach(), grad

    got = Ranks(size).run(rank, monkeypatch)
    for out, _ in got:
        assert rel_l2(out, want[0]) <= LIMIT
    assert rel_l2(torch.cat([r[1] for r in got], 2), want[1]) <= LIMIT


@pytest.mark.parametrize("depth,size", [(10, 4), (3, 4), (8, 2)])
def test_sharded_global_pool_in_bfloat16_rounds_as_the_whole_pool(
        depth, size, monkeypatch):
    """bfloat16: the whole pool (``x.mean``, which accumulates in float32
    and rounds once) and the sharded one (float32 block sums added over
    the ranks, rounded once) differ by the float32 summation order alone:
    the output and the input gradient within the distance of the float32
    pool from the bfloat16 one (its rounding control)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(1.0, 1.0, size=(2, 4, depth, 3, 5))
                         .astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
    want32 = whole_run(common.global_avg_pool, x.float(), g, [])
    want = whole_run(common.global_avg_pool, x, g.bfloat16(), [])

    def rank(space):
        local = space.register(block(x, space, depth).clone()
                               .requires_grad_(), depth)
        out = common.global_avg_pool(local)
        (grad,) = torch.autograd.grad(out, local, (g / size).bfloat16())
        return out.detach(), grad

    got = Ranks(size).run(rank, monkeypatch)
    control = [rel_l2(want[i].float(), want32[i]) for i in (0, 1)]
    for out, _ in got:
        assert out.dtype == torch.bfloat16
        assert rel_l2(out.float(), want[0].float()) <= control[0]
    grad = torch.cat([r[1] for r in got], 2)
    assert rel_l2(grad.float(), want[1].float()) <= control[1]


def test_max_pool_backward_keeps_its_fixed_order_inside_a_rank(monkeypatch):
    """Each rank's max pool backward is ``_MaxPool``'s (two runs, the same
    bits), also with the depth's padding taken by the halo."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 2, 8, 5, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 2, 4, 3, 3)).astype(np.float32))
    op = pool_op("max")
    a = sharded_run(op, x, g, [], 2, monkeypatch)
    b = sharded_run(op, x, g, [], 2, monkeypatch)
    assert torch.equal(a[1], b[1])


def stats_run(x, size, monkeypatch, mask=None, equal_weight=False):
    depth = x.shape[2]

    def rank(space):
        local = block(x, space, depth)
        if equal_weight:  # the planted fault: each rank's mean, averaged
            m = local.mean((0, 2, 3, 4))
            return space.reduce(m.clone(), torch.distributed.ReduceOp.SUM
                                ) / size, None
        mean, var, unbiased, _ = common.compute_batch_stats(local, mask)
        return mean, unbiased

    return Ranks(size).run(rank, monkeypatch)


@pytest.mark.parametrize("depth,size", [(10, 4), (9, 2), (3, 4)])
def test_batch_stats_weigh_each_rank_by_its_voxels(depth, size, monkeypatch):
    """Over uneven (and empty) blocks the statistics are the whole
    tensor's, masked or not; averaging the ranks' means, as the data
    axis may where every rank holds as many rows, is not."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(3, 5, depth, 4, 4)) * 2 + 1)
                         .astype(np.float32))
    mask = torch.tensor([1.0, 0.0, 1.0])
    for m in (None, mask):
        want = common.compute_batch_stats(x, m)
        for mean, unbiased in stats_run(x, size, monkeypatch, m):
            assert rel_l2(mean, want[0]) <= LIMIT
            assert rel_l2(unbiased, want[2]) <= LIMIT
    planted = stats_run(x, size, monkeypatch, equal_weight=True)[0][0]
    assert not rel_l2(planted, common.compute_batch_stats(x)[0]) <= 1e-3


def test_dropout_draws_the_whole_volume_and_keeps_the_rank_planes(
        monkeypatch):
    """An elementwise dropout of a depth-sharded activation draws the
    whole batch at full depth, as one process does, and keeps its planes;
    the channel dropout draws (B, C) and keeps nothing of depth."""
    x = torch.ones(2, 3, 7, 4, 4)
    drop = common.Dropout(0.5)
    drop.train()

    def rank(space):
        local = space.register(block(x, space, 7).clone(), 7)
        return drop(local, torch.Generator().manual_seed(5))

    want = drop(x, torch.Generator().manual_seed(5))
    got = torch.cat(Ranks(3).run(rank, monkeypatch), 2)
    assert torch.equal(got, want)


def test_rank_order_is_jax_make_mesh_device_order():
    """Rank r sits where device r sits in JAX's ``make_mesh`` on the 8
    virtual devices, for every mesh the tests run; the lines of a
    subgroup are JAX's lines along the axis."""
    from mmnn_sts_tpu.parallel.mesh import make_mesh as jax_make_mesh

    for shape, names in (([2, 2], ("data", "space")), ([1, 4], ("data",
                         "space")), ([4], ("space",)), ([1, 2, 2], (
                         "data", "space", "model")), ([2, 4], ("data",
                         "space")), ([2, 2, 2], ("space", "data", "model"))):
        n = int(np.prod(shape))
        jm = jax_make_mesh(shape, names, devices=jax.devices()[:n])
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(n):
            coords = mesh.Mesh(tuple(shape), names, r).coords
            assert ids[coords] == r
        for axes in mesh._sum_axis_sets(names):
            lines = mesh.axis_lines(tuple(shape), names, axes)
            moving = [names.index(a) for a in axes]
            fixed = [i for i in range(len(shape)) if i not in moving]
            want = ids.transpose(fixed + moving).reshape(
                -1, int(np.prod([shape[i] for i in moving])))
            assert lines == want.tolist(), (shape, names, axes)


def test_split_planes_and_windows():
    """Blocks differ by a plane at most and cover the depth in order; a
    window's reach follows from (depth, kernel, stride, pad, ranks)."""
    for depth in range(1, 20):
        for size in (2, 3, 4):
            blocks = [mesh.split_planes(depth, size, r) for r in range(size)]
            assert blocks[0][0] == 0 and blocks[-1][1] == depth
            assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
            sizes = [b - a for a, b in blocks]
            assert max(sizes) - min(sizes) <= 1
    head, tail, needs = mesh.window_plan(16, 2, 3, 1, 1)
    assert (head, tail, needs) == (1, 1, ((-1, 9), (7, 17)))
    assert mesh.window_plan(16, 2, 1, 1, 0)[:2] == (0, 0)


def test_config_parses_every_mesh_and_settles_the_space_axis():
    """``[data, space]``, ``[space]`` and a ``model`` axis parse; a depth
    the axis does not divide runs replicated over ``space``, and so does a
    2D or an image-free run."""
    import dataclasses

    m = mesh.Mesh((1, 4), ("data", "space"), 0, "gloo")
    assert mesh.space_on(m) and mesh.input_planes(m, 16) == (0, 4)
    assert not mesh.space_on(mesh.settle_space(m, 18))
    assert not mesh.space_on(mesh.settle_space(m, None))
    assert mesh.settle_space(m, 16) is m
    with pytest.raises(ValueError, match="settle"):
        mesh.input_planes(m, 18)
    assert mesh.input_planes(dataclasses.replace(m, rank=3), 16) == (12, 16)
    assert mesh.input_planes(mesh.Mesh((4,), ("data",), 0, "gloo"),
                             16) is None


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


def _jax_dense(sample_batch):
    from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny
    from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMM

    image = jax_tiny(**ranks_prog.TINY, out_channels=2, dropout_prob=0.0)
    return JaxMM(image_model=image, num_clinical_inputs=ranks_prog.P,
                 num_classes=2, num_features=4, blend=True,
                 clinical_dropout_prob=0.0), {
        "image": jnp.zeros((sample_batch,) + (ranks_prog.SIDE,) * 3 + (2,)),
        "clinical": jnp.zeros((sample_batch, ranks_prog.P))}


def _jax_cnn():
    from mmnn_sts_tpu.models.tinycnn import TinyCNN as JaxTinyCNN

    return JaxTinyCNN(in_channels=1, out_channels=2, feature_channels=4,
                      dropout_prob=0.0), jnp.zeros(
        (4,) + (ranks_prog.SIDE,) * 3 + (1,))


def _jax_state(model, sample, flat=None):
    from mmnn_sts_tpu.train.schedule import make_optimizer
    from mmnn_sts_tpu.train.state import create_train_state
    from test_torch_convert import jax_flat, jax_variables

    state = create_train_state(model, make_optimizer(
        ranks_prog.LR, ranks_prog.STEPS_PER_EPOCH, ranks_prog.EPOCHS),
        sample, seed=0)
    if flat is None:
        return state, jax_flat({"params": state.params,
                                "batch_stats": state.batch_stats})
    v = jax_variables(flat)
    return state.replace(params=v["params"],
                         batch_stats=v["batch_stats"]), flat


def make_spec() -> dict:
    """Weights (the JAX models' init, BatchNorm statistics and biases
    redrawn) and data, from seeds."""
    from test_torch_convert import randomise

    rng = np.random.default_rng(11)
    spec = {}
    for name, (model, sample) in (("dense", _jax_dense(4)),
                                  ("cnn", _jax_cnn())):
        flat = randomise(_jax_state(model, sample)[1], seed=3)
        spec.update({f"weights_{name}/{k}": v for k, v in flat.items()})

    def batch(prefix, lead, channels, side=ranks_prog.SIDE, clinical=False,
              labels=False, events=None):
        spec[f"{prefix}/image"] = (rng.normal(size=lead + (side,) * 3 + (
            channels,)) ** 2 * 500).astype(np.float32)
        if clinical:
            spec[f"{prefix}/clinical"] = rng.normal(
                size=lead + (ranks_prog.P,)).astype(np.float32)
        spec[f"{prefix}/events"] = (rng.random(lead + (2,)) < 0.7).astype(
            np.float32) if events is None else events
        spec[f"{prefix}/durations"] = rng.permutation(
            np.arange(1, 1 + int(np.prod(lead)) * 2)).reshape(
            lead + (2,)).astype(np.float32)
        if labels:
            spec[f"{prefix}/labels"] = (rng.random(lead + (2,)) < 0.5
                                        ).astype(np.float32)

    batch("dense", (2, 4), 2, clinical=True, labels=True)
    batch("cnn", (1, 4), 1)
    batch("cnn3", (1, 3), 1)
    batch("family", (1, 8), 2)
    batch("split", (8,), 1)
    spec["split/idx"] = rng.permutation(8).reshape(2, 1, 4)
    batch("gradcam", (4,), 2, side=ranks_prog.GRADCAM_SIDE, clinical=True,
          events=np.ones((4, 2), np.float32))
    return spec


# where the JAX package's own mesh of the ranks' shape is not its
# one-device run (ROADMAP Queue 3), the mesh the ranks are held against:
# * its blend classification step on a [2, 2] ``[data, space]`` mesh
#   updates the parameters 11.9 (relative L2) away from its one-device step
#   ([2, 1] and [1, 2]: 3.5e-3 and 2.6e-3, its reduction order; the same
#   with its loop's sharding anchors): one device;
# * its TinyCNN superstep on [1, 2, 2] over ``[data, space, model]``
#   updates them by 1.992 x its one-device step (relative L2 0.995; [1, 1,
#   2]: equal; [1, 2]: 2.6e-5): [1, 2] over ``[data, space]``, which a
#   ``model`` axis of replicas must equal
JAX_MESHES = {"classify": ([1, 1], ("data", "space")),
              "model": ([1, 2], ("data", "space"))}


def _jax_seresnet(spec, one):
    from mmnn_sts_tpu.models.seresnet import SEResNet50 as JaxSEResNet50

    lead = spec["family/image"].shape[1]
    return JaxSEResNet50(in_channels=2, num_classes=2), jnp.zeros(
        (lead,) + spec["family/image"].shape[2:]), {
        k[len("before_seresnet/"):]: v for k, v in one.items()
        if k.startswith("before_seresnet/")}


def jax_case(case: str, spec: dict, one: dict, work: Path) -> dict:
    """``case`` run by the JAX package on its virtual CPU devices, meshed
    as the ranks run it (``JAX_MESHES`` apart) with its training loop's
    sharding anchors (``data_axis``, ``space_axis``): {"loss", "after":
    flat weights}, or for ``infer`` {"preds", "maps": {file: map}} from
    its ``inference_survival`` with Grad-CAM into ``work / "jax_infer"``.
    SE-ResNet50 starts from the port's initial weights (``one``) and adds
    "grad": the eval-mode gradients of ``ranks_prog.eval_gradients``."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from mmnn_sts_tpu.data.loader import build_device_dataset as jax_dataset
    from mmnn_sts_tpu.infer import run as jax_run
    from mmnn_sts_tpu.ops.augment import eval_transform
    from mmnn_sts_tpu.parallel.mesh import make_mesh, replicate
    from mmnn_sts_tpu.train.loop import _data_axis
    from mmnn_sts_tpu.train.steps import (
        classification_train_step, survival_train_epoch,
        survival_train_superstep)
    from test_torch_convert import jax_flat

    shape, axes = JAX_MESHES.get(case, ranks_prog.MESHES[case])
    jm = make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
    if case == "seresnet":
        model, sample, flat = _jax_seresnet(spec, one)
    else:
        name = "dense" if case in ("classify", "infer") else "cnn"
        model, sample = _jax_cnn() if name == "cnn" else _jax_dense(4)
        flat = ranks_prog.weights(spec, name)
    state, _ = _jax_state(model, sample, flat)
    state = state.replace(params=replicate(jm, state.params),
                          batch_stats=replicate(jm, state.batch_stats),
                          opt_state=replicate(jm, state.opt_state))

    def put(x, *names):
        return jax.device_put(jnp.asarray(x), NamedSharding(jm, JP(*names)))

    grads = {}
    if case == "seresnet":
        def weighted(params, x):
            out = model.apply({"params": params,
                               "batch_stats": state.batch_stats},
                              jax.vmap(eval_transform)(x), train=False)
            return (out * jnp.asarray(np.linspace(
                -1.0, 1.0, out.size, dtype=np.float32)).reshape(
                out.shape)).sum()

        with jm:
            grads = jax_flat({"params": jax.jit(jax.grad(weighted))(
                state.params, put(spec["family/image"][0], "data",
                                  "space"))})
    if case in ("infer", "tinycnn_epoch"):
        prefix = "gradcam" if case == "infer" else "split"
        arrays = {k: spec[f"{prefix}/{k}"] for k in (
            "image", "clinical", "events", "durations")
            if f"{prefix}/{k}" in spec}
        ds = jax_dataset(np.arange(len(arrays["events"])), jm,
                         image_volumes=arrays.pop("image"), **arrays)
    if case == "infer":
        out = work / "jax_infer"
        got = jax_run.inference_survival(state, ds, jax_run.InferenceConfig(
            blend=True, gradcam=True, output_dir=str(out)))
        from mmnn_sts_torch.data.nifti import load_nifti

        return {"preds": np.asarray(got["preds"]), "maps": {
            p.relative_to(out): load_nifti(str(p))
            for p in out.rglob("*.nii*")}}
    with jm:
        if case == "tinycnn_epoch":
            idx = jnp.asarray(spec["split/idx"], jnp.int32)
            new, aux = survival_train_epoch(
                state, ds.model_inputs(), ds.events, ds.durations, idx,
                jax.random.key(0), blend=False, augment=False,
                data_axis=_data_axis(jm, idx.shape[-1]), space_axis="space")
        elif case == "classify":
            rows = ("data", "space")
            new, aux = classification_train_step(
                state, {"image": put(spec["dense/image"][0], *rows),
                        "clinical": put(spec["dense/clinical"][0], "data")},
                put(spec["dense/labels"][0], "data"), jnp.full((2,), 1.5),
                jax.random.key(0), blend=True, augment=False,
                data_axis=_data_axis(jm, 4), space_axis="space")
        else:  # a superstep: tinycnn, model, seresnet
            batch = {"seresnet": "family", "model": "cnn3"}.get(case, "cnn")
            image = spec[f"{batch}/image"]
            new, aux = survival_train_superstep(
                state, put(image, None, "data", "space"),
                put(spec[f"{batch}/events"], None, "data"),
                put(spec[f"{batch}/durations"], None, "data"),
                jax.random.key(0), blend=False, augment=False,
                data_axis=_data_axis(jm, image.shape[1]), space_axis="space")
    return {"loss": np.asarray(aux["loss"]), "grad": grads,
            "after": jax_flat({"params": new.params,
                               "batch_stats": new.batch_stats})}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the spec, each rank's results, the one-process port's, the work
    directory)."""
    work = tmp_path_factory.mktemp("space")
    spec = make_spec()
    np.savez(work / "spec.npz", **spec)
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{REPO / 'tests'}",
           "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "test_torch_space_ranks.py"),
         str(work)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    one = ranks_prog.one_process(spec, work / "one")
    logs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "ok" in out, (r, out, err[-4000:])
    got = []
    for r in range(4):
        with np.load(work / f"rank{r}.npz") as data:
            got.append({k: data[k] for k in data.files})
    return spec, got, one, work


@pytest.mark.parametrize("case", ranks_prog.CHECKED)
def test_ranks_match_the_one_process_port(runs, case):
    """First outputs within 1e-5 relative L2, the update within 4 x the
    one-ulp control (``ranks_prog.check``)."""
    spec, got, one, _ = runs
    for r in range(4):
        print(case, r, ranks_prog.check(case, got[r], one, spec))


@pytest.mark.parametrize("fault", ranks_prog.FAULTS)
def test_each_planted_fault_is_caught(runs, fault):
    spec, got, one, _ = runs
    with pytest.raises(AssertionError):
        ranks_prog.check(ranks_prog.FAULTS[fault], got[0], one, spec,
                         prefix=fault)


def test_model_axis_replicas_equal_the_mesh_without_it(runs):
    """``[1, 2, 2]`` over ``[data, space, model]``: every rank holds the
    numbers of ``[2, 2]`` over ``[data, space]`` run on 3 rows (which the
    ``data`` axis does not divide: a two-rank ``space`` axis beside its
    replicas, as ``[1, 2]``) bit for bit."""
    got = runs[1]
    keys = [k for k in got[0] if k.startswith("model/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_array_equal(got[0][k], got[2][k], err_msg=k)
        np.testing.assert_array_equal(got[0][k], got[3][k], err_msg=k)
        np.testing.assert_array_equal(
            got[0][k], got[0][k.replace("model/", "replicas/", 1)],
            err_msg=k)


def test_only_rank_0_writes_and_gradcam_maps_match(runs):
    """Inference with Grad-CAM at 32^3 over ``[2, 2]``: rank 0 alone
    writes, its maps within 1e-3 of one process's, and the eval
    predictions within 1e-5."""
    spec, got, one, work = runs
    for r in range(1, 4):
        assert not list((work / f"rank{r}").rglob("*.*")), r
    maps = sorted((work / "rank0" / "infer" / "attention_maps").rglob(
        "*.nii*"))
    want = sorted((work / "one" / "infer" / "attention_maps").rglob(
        "*.nii*"))
    assert [p.relative_to(work / "rank0") for p in maps] == [
        p.relative_to(work / "one") for p in want] and maps
    from mmnn_sts_torch.data.nifti import load_nifti

    for a, b in zip(maps, want):
        np.testing.assert_allclose(load_nifti(str(a)), load_nifti(str(b)),
                                   atol=1e-3, err_msg=str(a))
    np.testing.assert_allclose(got[0]["infer/preds"], one["infer/preds"],
                               rtol=1e-5, atol=1e-6)


def test_collectives_and_resident_slab(runs):
    """Each rank of ``[4]`` over ``[space]`` holds a quarter of the
    resident split's planes, and the TinyCNN superstep's halo exchanges
    on ``[1, 4]`` are its five VALID convolutions' (forward)."""
    got = runs[1]
    for r in range(4):
        assert int(got[r]["tinycnn_epoch/slab_planes"]) == \
            ranks_prog.SIDE // 4
        assert int(got[r]["tinycnn/halos"]) == 5


@pytest.mark.parametrize("case", ranks_prog.JAX_CASES)
def test_ranks_match_jax_on_a_mesh_of_the_same_shape(runs, case):
    """The cases without random draws against the JAX package on its
    virtual devices, meshed as the ranks (``JAX_MESHES`` apart), within
    JAX's own tolerances (tests/test_spatial_parallel.py): the loss within
    rtol 1e-4; TinyCNN's superstep, epoch and ``model`` superstep in every
    parameter and BatchNorm statistic within rtol 1e-4, atol 1e-5;
    ``infer``'s predictions and Grad-CAM maps (the same files) within rtol
    1e-4, atol 1e-5. SE-ResNet50: its eval-mode gradients (halo exchanges,
    SE pools, gradient sums) within rtol 1e-4, atol 1e-5; its train-mode
    update, which a one-ulp change of the input moves by 0.25 (relative
    L2: 16 blocks of BatchNorm at init), within 4 x that control as
    against one process. The DenseNet blend, whose update moves by 2e-2
    under a one-ulp change of its input (tests/test_torch_train_steps.py):
    the update in relative L2 within that file's 1e-2 over all parameters
    and 3e-2 a tensor, its BatchNorm statistics within 1e-4."""
    spec, got, one, work = runs
    want = jax_case(case, spec, one, work)
    if case == "infer":
        np.testing.assert_allclose(got[0]["infer/preds"], want["preds"],
                                   rtol=1e-4, atol=1e-5)
        from mmnn_sts_torch.data.nifti import load_nifti

        mine = work / "rank0" / "infer"
        assert sorted(want["maps"]) == sorted(
            p.relative_to(mine) for p in mine.rglob("*.nii*"))
        for path, v in want["maps"].items():
            np.testing.assert_allclose(load_nifti(str(mine / path)), v,
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=str(path))
        return
    np.testing.assert_allclose(got[0][f"{case}/loss"], want["loss"],
                               rtol=1e-4)
    if case == "seresnet":
        for key, v in want["grad"].items():
            np.testing.assert_allclose(got[0][f"{case}/grad/{key}"], v,
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        before = {k[len("before_seresnet/"):]: v for k, v in one.items()
                  if k.startswith("before_seresnet/") and "/params/" in k}

        def update(after):
            return [after(k) - v for k, v in before.items()]

        mine = update(lambda k: got[0][f"{case}/after/{k}"])
        err = ranks_prog.rel_l2(mine, update(lambda k: want["after"][k]))
        control = ranks_prog.rel_l2(
            update(lambda k: one[f"{case}/control/after/{k}"]),
            update(lambda k: one[f"{case}/after/{k}"]))
        print(f"{case} vs JAX: update rel L2 {err:.2e}, control "
              f"{control:.2e}")
        assert err <= ranks_prog.CONTROL_FACTOR * control, (err, control)
        return
    if case != "classify":
        for key, v in want["after"].items():
            np.testing.assert_allclose(got[0][f"{case}/after/{key}"], v,
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        return
    before = ranks_prog.weights(spec, "dense")
    deltas = {}
    for key, v in want["after"].items():
        g = got[0][f"{case}/after/{key}"]
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(g, v, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
            continue
        deltas[key] = (g - before[key], v - before[key])
    num = sum(float(np.sum((dg - dw) ** 2)) for dg, dw in deltas.values())
    den = sum(float(np.sum(dw ** 2)) for _, dw in deltas.values())
    err = (num / den) ** 0.5
    # a tensor whose update is roundoff (the biases of the dense layers
    # before a BatchNorm, whose true gradient is 0) has no relative error
    largest = max(np.linalg.norm(dw) for _, dw in deltas.values())
    worst = max(float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))
                for dg, dw in deltas.values()
                if np.linalg.norm(dw) > 1e-3 * largest)
    print(f"{case} vs JAX: update rel L2 {err:.2e}, worst tensor "
          f"{worst:.2e}")
    assert err <= 1e-2 and worst <= 3e-2, (err, worst)
