"""One rank of the port's ``[data, space]`` meshes on the CPU, for
tests/test_torch_space.py (which spawns four of them over gloo); it holds
no test of its own:

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/test_torch_space_ranks.py WORKDIR

Run as a script, jax, flax, optax, the JAX package, pandas, matplotlib and
yaml are blocked before anything is imported (the test imports this module
for the one-process run and the checks). The rank initialises the process
group with ``parallel/mesh.maybe_initialize_distributed`` and runs every
case of ``CASES`` from ``WORKDIR/spec.npz``, each on its own mesh of the
four ranks, as the one-process run would be called except that each
rank passes its depth slab of every volume (``mesh.input_planes``):

* ``pair``, ``[2, 2]`` over ``[data, space]``: the narrow TinyDenseNet
  multimodal blend superstep (A = 2 microbatches of B = 4 at 16^3: its
  last block is 1 plane deep, so one ``space`` rank's block is empty),
  augmented, dropout 0.2;
* ``tinycnn``, ``[1, 4]``: TinyCNN at 16^3, the model of the JAX
  package's tests/test_spatial_parallel.py (its VALID convolutions leave
  blocks of 4, 4, 3, 3 planes), one superstep (A = 1, B = 4), and
  ``tinycnn_epoch``, ``[4]`` over ``[space]`` alone (no ``data`` axis, as
  the JAX package's space-only epoch test), ``survival_train_epoch`` over
  a resident split of 8 (two supersteps of B = 4);
* ``classify``, ``[2, 2]``: the blend classification step (B = 4);
* ``infer``, ``[2, 2]``: ``inference_survival`` with Grad-CAM at 32^3 of
  a split of 4 into ``WORKDIR/rank<r>/infer/``;
* ``model``, ``[1, 2, 2]`` over ``[data, space, model]``, and
  ``replicas``, ``[2, 2]`` over ``[data, space]``: TinyCNN's superstep
  at B = 3 rows, which the ``data`` axis does not divide, so both are a
  two-rank ``space`` axis with replicas beside it;
* ``seresnet`` (``[1, 4]``) and ``r3d`` (``[2, 2]``): one superstep of
  SE-ResNet50 and R3D-18 at 16^3, B = 8 (SE-ResNet's stages run 1, 1, 0
  and 0 planes a rank, its last ones one plane on one rank); SE-ResNet50
  also takes the gradients of its eval-mode outputs first
  (``eval_gradients``);
* planted faults, each a case run with one piece broken: ``fault_scale``
  (the loss not weighted by 1 / space: replicated gradients summed over
  the ranks), ``fault_stats`` (BatchNorm statistics left per rank),
  ``fault_halo`` (halos of zeros), ``fault_equal`` (each rank's mean
  weighted equally over uneven blocks), all on ``tinycnn``, and
  ``fault_se`` (the SE blocks' gradients left unsummed) on ``seresnet``.

Writes ``WORKDIR/rank<r>.npz``: each case's losses, predictions and
weights after it (and ``infer``'s predictions), in the JAX key scheme.
"""

import sys

BLOCKED = ("pandas", "matplotlib", "yaml", "jax", "jaxlib", "flax", "optax",
           "mmnn_sts_tpu")
if __name__ == "__main__":  # a rank: before anything imports them
    for name in BLOCKED:
        sys.modules[name] = None

import contextlib  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat  # noqa: E402
from mmnn_sts_torch.data.loader import build_device_dataset  # noqa: E402
from mmnn_sts_torch.infer.run import (  # noqa: E402
    InferenceConfig, inference_survival)
from mmnn_sts_torch.models import common  # noqa: E402
from mmnn_sts_torch.models.densenet import tiny_densenet  # noqa: E402
from mmnn_sts_torch.models.multimodal import MultiModalModel  # noqa: E402
from mmnn_sts_torch.models.resnet3d import ResNet3D18  # noqa: E402
from mmnn_sts_torch.models.seresnet import SEResNet50  # noqa: E402
from mmnn_sts_torch.models.tinycnn import TinyCNN  # noqa: E402
from mmnn_sts_torch.ops.augment import eval_transform_batch  # noqa: E402
from mmnn_sts_torch.parallel import mesh  # noqa: E402
from mmnn_sts_torch.train.schedule import make_optimizer  # noqa: E402
from mmnn_sts_torch.train.state import create_train_state  # noqa: E402
from mmnn_sts_torch.train.steps import (  # noqa: E402
    classification_train_step, survival_train_epoch,
    survival_train_superstep)

torch.set_num_threads(1)

P, SIDE, GRADCAM_SIDE = 11, 16, 32
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
LR, STEPS_PER_EPOCH, EPOCHS = 0.05, 2, 3
# case -> (mesh shape, axes)
MESHES = {
    "pair": ([2, 2], ("data", "space")),
    "tinycnn": ([1, 4], ("data", "space")),
    "tinycnn_epoch": ([4], ("space",)),
    "classify": ([2, 2], ("data", "space")),
    "infer": ([2, 2], ("data", "space")),
    "model": ([1, 2, 2], ("data", "space", "model")),
    "replicas": ([2, 2], ("data", "space")),
    "seresnet": ([1, 4], ("data", "space")),
    "r3d": ([2, 2], ("data", "space")),
}
# a planted fault -> the case it breaks
FAULTS = {"fault_scale": "tinycnn", "fault_stats": "tinycnn",
          "fault_halo": "tinycnn", "fault_equal": "tinycnn",
          "fault_se": "seresnet"}
CASES = tuple(MESHES) + tuple(FAULTS)
# the cases held against the one-process port (``check``)
CHECKED = ("pair", "tinycnn", "tinycnn_epoch", "classify", "model",
           "replicas", "seresnet", "r3d")
# the cases held against the JAX package on a mesh of the same shape
JAX_CASES = ("tinycnn", "tinycnn_epoch", "classify", "infer", "model",
             "seresnet")
FIRST_LIMIT = 1e-5  # relative L2 of the first losses and predictions
CONTROL_FACTOR = 4.0  # the update against the one-ulp control
UPDATE_FLOOR = 1e-5
ULP = 1 + 2.0 ** -22  # the control's scale of the input volumes


def dense_model(spec, dropout=0.0):
    torch.manual_seed(0)
    encoder = tiny_densenet(**TINY, out_channels=None, dropout_prob=dropout)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=dropout)
    return load_jax_npz(model, weights(spec, "dense"))


def cnn_model(spec):
    model = TinyCNN(in_channels=1, out_channels=2, feature_channels=4,
                    dropout_prob=0.0)
    return load_jax_npz(model, weights(spec, "cnn"))


def family_model(name):
    torch.manual_seed(1)
    if name == "seresnet":
        return SEResNet50(in_channels=2, num_classes=2)
    return ResNet3D18(in_channels=2, num_classes=2)


def weights(spec, prefix):
    return {k[len(prefix) + 9:]: v for k, v in spec.items()
            if k.startswith(f"weights_{prefix}/")}


def state_of(model, ranks, seed=0):
    opt, sched = make_optimizer(model.parameters(), LR, STEPS_PER_EPOCH,
                                EPOCHS)
    return create_train_state(model, opt, sched, seed=seed, mesh=ranks)


def slab(x, ranks, dim):
    """This rank's depth planes of x (whole without a mesh)."""
    planes = mesh.input_planes(ranks, x.shape[dim])
    if planes is None:
        return x
    return x.narrow(dim, planes[0], planes[1] - planes[0]).contiguous()


def tensors(spec, prefix, ranks, scale=1.0, depth_dim=2):
    def get(key):
        key = f"{prefix}/{key}"
        return torch.from_numpy(spec[key]) if key in spec else None

    image = get("image") * scale
    inputs = slab(image, ranks, depth_dim)
    if get("clinical") is not None:
        inputs = {"image": inputs, "clinical": get("clinical")}
    return inputs, get("events"), get("durations"), get("labels")


@contextlib.contextmanager
def planted(fault, model):
    """The fault ``fault`` in place for the block."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "fault_scale":
        patch(mesh.Shard, "backward", lambda self, loss: loss.backward())
    elif fault == "fault_stats":
        patch(mesh.Shard, "all_reduce", lambda self, x: x)
    elif fault == "fault_halo":
        patch(mesh, "_strip", lambda xl, head, tail: xl.new_zeros(
            (xl.shape[0], head + tail) + xl.shape[2:]))
    elif fault == "fault_equal":
        real = common.compute_batch_stats

        def equal(x, mask=None):
            shard = mesh.active_shard()
            if shard is None or shard.space is None or x.dim() != 5:
                return real(x, mask)
            dims = (0, 2, 3, 4)
            mean, mean_sq = (shard.all_reduce(torch.cat([
                x.mean(dims), x.square().mean(dims)])) / shard.size).split(
                x.shape[1])
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            return mean, var, var, None

        patch(common, "compute_batch_stats", equal)
    elif fault == "fault_se":
        se = {id(p) for n, p in model.named_parameters() if ".se." in n}
        real = mesh.Shard.sum_gradients

        def unsummed(self, grads):
            real(self, [p.grad for p in model.parameters()
                        if id(p) not in se])

        patch(mesh.Shard, "sum_gradients", unsummed)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def after(state) -> dict:
    return {f"after/{k}": v for k, v in to_jax_flat(
        state.model.state_dict(), layout="unfused").items()}


def run_case(case, spec, ranks, workdir: Path, scale=1.0) -> dict:
    """One case on this rank (``ranks`` None: the one-process run; ``scale``
    multiplies the input volumes, the control)."""
    fault = case if case in FAULTS else None
    base = FAULTS.get(case, case)
    if base in ("pair", "classify", "infer"):
        model = dense_model(spec, dropout=0.2 if base == "pair" else 0.0)
    elif base in ("seresnet", "r3d"):
        model = family_model(base)
    else:
        model = cnn_model(spec)
    state = state_of(model, ranks)
    out = {}
    with planted(fault, model):
        if base in ("pair", "tinycnn", "model", "replicas", "seresnet",
                    "r3d"):
            batch = {"pair": "dense", "seresnet": "family",
                     "r3d": "family"}.get(base, "cnn3" if base in (
                         "model", "replicas") else "cnn")
            inputs, events, durations, _ = tensors(spec, batch, ranks, scale)
            if base == "seresnet":
                out.update(eval_gradients(model, inputs[0], ranks))
            mesh.reset_counts()
            aux = survival_train_superstep(
                state, inputs, events, durations, blend=base == "pair",
                augment=base == "pair")
            out["halos"] = np.asarray(mesh.space_counts["halo"])
        elif base == "tinycnn_epoch":
            inputs, events, durations, _ = tensors(spec, "split", None, scale)
            ds = build_device_dataset(
                np.arange(len(events)), "cpu", image_volumes=inputs.numpy(),
                events=events.numpy(), durations=durations.numpy(),
                planes=mesh.input_planes(ranks, SIDE))
            aux = survival_train_epoch(state, ds, spec["split/idx"],
                                       augment=False)
            out["slab_planes"] = np.asarray(ds.inputs["image"].shape[1])
        elif base == "classify":
            inputs, _, _, labels = tensors(spec, "dense", ranks, scale)
            inputs = {k: v[0] for k, v in inputs.items()}
            aux = classification_train_step(
                state, inputs, labels[0], torch.full((2,), 1.5), blend=True,
                augment=False)
        else:  # infer
            inputs, events, durations, _ = tensors(spec, "gradcam", None)
            ds = build_device_dataset(
                np.arange(len(events)), "cpu",
                image_volumes=inputs["image"].numpy(),
                clinical=inputs["clinical"].numpy(), events=events.numpy(),
                durations=durations.numpy(),
                planes=mesh.input_planes(ranks, GRADCAM_SIDE))
            rank_dir = workdir / f"rank{ranks.rank}" if ranks else workdir
            (rank_dir / "infer").mkdir(parents=True, exist_ok=True)
            got = inference_survival(state, ds, InferenceConfig(
                blend=True, gradcam=True, output_dir=str(rank_dir / "infer")))
            return {"preds": np.asarray(got["preds"])}
    out["loss"] = aux["loss"].detach().numpy()
    out["preds"] = aux["preds"].detach().float().numpy()
    out.update(after(state))
    return out


def eval_gradients(model, image, ranks) -> dict:
    """The parameters' gradients of a fixed weighting of the eval-mode
    outputs (running BatchNorm statistics) on ``image`` (B, D', H, W, C),
    sharded and summed as a step does (``parallel/mesh.py``'s gradient
    rule), in the JAX key scheme: {"grad/params/..."}. Unlike a
    train-mode step of SE-ResNet50 at init, this is well conditioned, so
    its halo exchanges, SE pools and gradient sums are held at 1e-5."""
    model.eval()
    model.zero_grad(set_to_none=True)
    shard = mesh.step_shard(ranks, image.shape[0], image)
    with mesh.sharded(shard):
        x = eval_transform_batch(image, space=mesh.active_space())
        out = model(x)
        if shard is not None:
            out = shard.gather(out)
        loss = (out * torch.from_numpy(np.linspace(
            -1.0, 1.0, out.numel(), dtype=np.float32)).view(out.shape)).sum()
        if shard is None:
            loss.backward()
        else:
            shard.backward(loss)
            shard.sum_gradients([p.grad for p in model.parameters()])
    flat = dict(model.state_dict())
    flat.update((n, p.grad) for n, p in model.named_parameters())
    grads = {f"grad/{k}": v for k, v in to_jax_flat(flat).items()
             if k.startswith("params/")}
    model.zero_grad(set_to_none=True)
    return grads


def one_process(spec, workdir: Path) -> dict:
    """Every checked case without a process group, and its control (the
    volumes scaled by ``ULP``); the initial weights of each model."""
    out = {}
    for case in CHECKED + ("infer",):
        got = run_case(case, spec, None, workdir)
        out.update({f"{case}/{k}": v for k, v in got.items()})
        if case == "infer":
            continue
        ctl = run_case(case, spec, None, workdir, scale=ULP)
        out.update({f"{case}/control/{k}": v for k, v in ctl.items()})
    for name, model in (("dense", dense_model(spec)),
                        ("cnn", cnn_model(spec)),
                        ("seresnet", family_model("seresnet")),
                        ("r3d", family_model("r3d"))):
        out.update({f"before_{name}/{k[len('after/'):]}": v
                    for k, v in after(state_of(model, None)).items()})
    return out


def rel_l2(got, want) -> float:
    """|got - want| / |want| over the lists of arrays, each taken whole."""
    num = den = 0.0
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w, np.float64)
        num += float(np.square(np.asarray(g, np.float64) - w).sum())
        den += float(np.square(w).sum())
    return (num / max(den, 1e-60)) ** 0.5


def check(case, got, one, spec, prefix=None):
    """Raise AssertionError unless the rank's ``prefix`` (default: the
    case) run holds the one-process run of ``case``: the first losses and
    predictions (before any update; the epoch's first superstep) and the
    BatchNorm statistics the superstep leaves (from the same forwards)
    within
    ``FIRST_LIMIT`` relative L2, the update of the parameters (new - old,
    over all of them) within ``CONTROL_FACTOR`` x the one-ulp control's,
    floored at ``UPDATE_FLOOR``. Where the one-ulp control itself moves
    the first outputs by more than ``FIRST_LIMIT / CONTROL_FACTOR`` (a
    train-mode SE-ResNet50, whose 16 blocks of BatchNorm amplify a
    rounding 300-fold at init), they too are held at ``CONTROL_FACTOR``
    x the control. Returns the distances and limits."""
    prefix = prefix or case
    model = {"pair": "dense", "classify": "dense", "seresnet": "seresnet",
             "r3d": "r3d"}.get(case, "cnn")
    n = 1 if case == "tinycnn_epoch" else None
    stats = [] if n else sorted(k[len(case) + 1:] for k in one if k.startswith(
        f"{case}/after/batch_stats/"))

    def first(d, p):
        return [d[f"{p}/loss"].reshape(-1)[:n], d[f"{p}/preds"][:n]] + [
            d[f"{p}/{k}"] for k in stats]

    first_err = rel_l2(first(got, prefix), first(one, case))
    first_limit = max(FIRST_LIMIT, CONTROL_FACTOR * rel_l2(
        first(one, f"{case}/control"), first(one, case)))
    before = {k[len(f"before_{model}/"):]: v for k, v in one.items()
              if k.startswith(f"before_{model}/")}
    params = [k for k in before if k.startswith("params/")]

    def update(d, p):
        return [d[f"{p}/after/{k}"] - before[k] for k in params]

    want = update(one, case)
    err = rel_l2(update(got, prefix), want)
    control = rel_l2(update(one, f"{case}/control"), want)
    limit = max(UPDATE_FLOOR, CONTROL_FACTOR * control)
    grads = sorted(k[len(case) + 1:] for k in one
                   if k.startswith(f"{case}/grad/"))
    if grads:
        def grad(d, p):
            return [d[f"{p}/{k}"] for k in grads]

        grad_err = rel_l2(grad(got, prefix), grad(one, case))
        grad_limit = max(UPDATE_FLOOR, CONTROL_FACTOR * rel_l2(
            grad(one, f"{case}/control"), grad(one, case)))
        assert grad_err <= grad_limit, (
            f"{prefix} vs one process: eval-mode gradients rel L2 "
            f"{grad_err:.2e} (limit {grad_limit:.2e})")
    assert first_err <= first_limit and err <= limit, (
        f"{prefix} vs one process: first outputs rel L2 {first_err:.2e} "
        f"(limit {first_limit:.2e}); update rel L2 {err:.2e} (limit "
        f"{limit:.2e}, one-ulp control {control:.2e})")
    return first_err, first_limit, err, limit


def main(workdir: str) -> int:
    workdir = Path(workdir)
    assert mesh.maybe_initialize_distributed("cpu")
    with np.load(workdir / "spec.npz") as data:
        spec = {k: data[k] for k in data.files}
    meshes = {}
    results = {}
    for case in CASES:
        shape, axes = MESHES[FAULTS.get(case, case)]
        key = (tuple(shape), axes)
        if key not in meshes:
            meshes[key] = mesh.make_mesh(shape, axes)
        got = run_case(case, spec, meshes[key], workdir)
        results.update({f"{case}/{k}": v for k, v in got.items()})
    rank = torch.distributed.get_rank()
    np.savez(workdir / f"rank{rank}.npz", **results)
    bad = sorted(k for k in sys.modules if sys.modules[k] is not None
                 and k.split(".")[0] in BLOCKED)
    assert not bad, bad
    torch.distributed.destroy_process_group()
    print(f"rank {rank} of 4: ok ({os.getpid()})")
    return 0


def halo_on_the_card(workdir: str) -> int:
    """Two gloo ranks sharing the card: a k3 p1 convolution of a
    depth-sharded activation, forward and backward, against the whole
    convolution on the card."""
    assert mesh.maybe_initialize_distributed("cuda")
    ranks = mesh.make_mesh([1, 2], ("data", "space"))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    conv = common.conv(3, 4, 3, padding=1, use_bias=True).cuda()
    x = torch.randn(2, 8, 6, 5, 3, device="cuda")  # (N, D, H, W, C)
    g = torch.randn(2, 4, 8, 6, 5, device="cuda")
    whole = x.movedim(-1, 1).clone().requires_grad_()
    want = conv(common.channels_last(whole))
    want.backward(g)
    local = slab(x, ranks, 1).movedim(-1, 1).clone().requires_grad_()
    shard = mesh.step_shard(ranks, None, slab(x, ranks, 1))
    with mesh.sharded(shard):
        got = conv(common.channels_last(local))
    a, b = mesh.input_planes(ranks, 8)
    got.backward(g[:, :, a:b])
    assert got.is_cuda and mesh.space_counts["halo"] == 1
    torch.testing.assert_close(got, want[:, :, a:b], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(local.grad, whole.grad[:, :, a:b], rtol=1e-5,
                               atol=1e-5)
    torch.distributed.destroy_process_group()
    print("ok")
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--halo-on-the-card":
        raise SystemExit(halo_on_the_card(sys.argv[2]))
    raise SystemExit(main(sys.argv[1]))
