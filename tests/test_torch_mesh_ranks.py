"""One rank of the port's ``data`` mesh on the CPU, for
tests/test_torch_mesh.py (which spawns two of them over gloo); it holds no
test of its own:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/test_torch_mesh_ranks.py WORKDIR

Run as a script, jax, flax, optax, the JAX package, pandas, matplotlib and
yaml are blocked before anything is imported (the test imports this module
for the one-process run). The rank initialises the process
group with ``parallel/mesh.maybe_initialize_distributed`` and runs every
case of ``WORKDIR/spec.npz`` from the same weights, each as the
one-process run would be called (the same global batch on every rank):

* ``survival``: one multimodal blend superstep, A = 2 microbatches of
  B = 4, Efron ties, the second microbatch ragged (mask), augmentation off,
  dropout 0;
* ``survival_random``: the same superstep with the augmentation on and
  dropout 0.2 (Breslow, no mask), the draws from the state's generator;
* ``planted``: ``survival`` with the output gather's backward summing the
  gradient over the ranks, as ``torch.distributed.nn``'s all-gather does;
* ``classification``: one blend classification step of B = 4, ragged;
* ``epoch``: ``survival_train_epoch`` over a resident split, two full
  supersteps and a ragged tail, with the validation forward;
* ``loop``: ``train_survival`` for one epoch with a checkpoint directory,
  into ``WORKDIR/rank<r>/``;
* ``inference``: ``inference_survival`` of the validation split (no
  Grad-CAM), its CSV into ``WORKDIR/rank<r>/infer/``;
* ``planar``: a 2D TinyCNN's eval forward (the 2D path without jax).

Writes ``WORKDIR/rank<r>.npz``: each case's loss, predictions and weights
after it, in the JAX key scheme, and the collectives each case issued.
"""

import sys

BLOCKED = ("pandas", "matplotlib", "yaml", "jax", "jaxlib", "flax", "optax",
           "mmnn_sts_tpu")
if __name__ == "__main__":  # a rank: before anything imports them
    for name in BLOCKED:
        sys.modules[name] = None

import os  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat  # noqa: E402
from mmnn_sts_torch.data.loader import build_device_dataset  # noqa: E402
from mmnn_sts_torch.infer.run import (  # noqa: E402
    InferenceConfig, inference_survival)
from mmnn_sts_torch.models.densenet import tiny_densenet  # noqa: E402
from mmnn_sts_torch.models.multimodal import MultiModalModel  # noqa: E402
from mmnn_sts_torch.models.tinycnn import TinyCNN  # noqa: E402
from mmnn_sts_torch.parallel import mesh  # noqa: E402
from mmnn_sts_torch.train.loop import LoopConfig, train_survival  # noqa
from mmnn_sts_torch.train.schedule import make_optimizer  # noqa: E402
from mmnn_sts_torch.train.state import create_train_state  # noqa: E402
from mmnn_sts_torch.train.steps import (  # noqa: E402
    classification_train_step, survival_train_epoch,
    survival_train_superstep)

torch.set_num_threads(1)

P = 11
TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)
LR, STEPS_PER_EPOCH, EPOCHS = 2.5, 2, 3
# the epoch's and the loop's peak rate: at LR their later steps diverge
RUN_LR = 0.05


def build_state(flat, ranks, dropout=0.0, lr=LR):
    """The narrow multimodal blend model on ``flat``'s weights, its state
    over ``ranks`` (None: one process)."""
    torch.manual_seed(0)
    encoder = tiny_densenet(**TINY, out_channels=None, dropout_prob=dropout)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=dropout)
    load_jax_npz(model, flat)
    opt, sched = make_optimizer(model.parameters(), lr, STEPS_PER_EPOCH,
                                EPOCHS)
    return create_train_state(model, opt, sched, seed=0, mesh=ranks)


def batch(spec, prefix):
    """(inputs, events, durations, labels, mask) of the spec's batch
    ``prefix`` as tensors (None where absent)."""
    def get(key):
        key = f"{prefix}/{key}"
        return torch.from_numpy(spec[key]) if key in spec else None

    return ({"image": get("image"), "clinical": get("clinical")},
            get("events"), get("durations"), get("labels"), get("mask"))


def weights(state):
    return to_jax_flat(state.model.state_dict(), layout="unfused")


def run_case(name, spec, flat, ranks, workdir: Path) -> dict:
    """One case on this rank: {"loss", "preds", "after/<key>", ...}."""
    out = {}
    if name in ("survival", "survival_random", "planted"):
        state = build_state(flat, ranks,
                            dropout=0.2 if name == "survival_random" else 0)
        inputs, events, durations, _, mask = batch(spec, "survival")
        random = name == "survival_random"
        aux = survival_train_superstep(
            state, inputs, events, durations, blend=True, augment=random,
            ties="breslow" if random else "efron",
            mask=None if random else mask)
    elif name == "classification":
        state = build_state(flat, ranks)
        inputs, _, _, labels, mask = batch(spec, "classification")
        aux = classification_train_step(
            state, inputs, labels, torch.full((2,), 1.5), blend=True,
            augment=False, mask=mask)
    elif name == "epoch":
        state = build_state(flat, ranks, lr=RUN_LR)
        train, val = split(spec, "train"), split(spec, "val")
        aux = survival_train_epoch(
            state, train, spec["epoch/idx"], spec["epoch/tail_idx"],
            torch.from_numpy(spec["epoch/tail_mask"]), val_ds=val,
            blend=True, augment=False, with_val=True)
        out["val_preds"] = aux["val_preds"].numpy()
        out["val_loss"] = aux["val_loss"].numpy()
    elif name == "loop":
        state = build_state(flat, ranks, lr=RUN_LR)
        rank_dir = workdir / f"rank{ranks.rank if ranks else 0}"
        train_survival(state, split(spec, "train"), split(spec, "val"),
                       LoopConfig(epochs=1, batch_size=4, super_batch=8,
                                  blend=True, augment=False,
                                  output_dir=str(rank_dir / "out"),
                                  checkpoint_dir=str(rank_dir / "ckpt"),
                                  save_params_name="best.npz"))
        return {"loss": np.zeros(()), "preds": np.zeros(())}
    elif name == "inference":
        state = build_state(flat, ranks, lr=RUN_LR)
        rank_dir = workdir / f"rank{ranks.rank if ranks else 0}" / "infer"
        rank_dir.mkdir(parents=True, exist_ok=True)  # as the CLI makes it
        got = inference_survival(state, split(spec, "val"), InferenceConfig(
            blend=True, gradcam=False, output_dir=str(rank_dir)))
        return {"loss": np.zeros(()), "preds": np.asarray(got["preds"])}
    elif name == "planar":
        torch.manual_seed(0)
        model = TinyCNN(in_channels=2, out_channels=2, dropout_prob=0.0,
                        spatial_dims=2).eval()
        with torch.no_grad():
            preds = model(torch.from_numpy(spec["planar/image"]))
        return {"loss": np.zeros(()), "preds": preds.numpy()}
    out["loss"] = aux["loss"].detach().numpy()
    out["preds"] = aux["preds"].detach().float().numpy()
    out.update({f"after/{k}": v for k, v in weights(state).items()})
    return out


def split(spec, prefix):
    inputs, events, durations, _, _ = batch(spec, prefix)
    n = events.shape[0]
    return build_device_dataset(
        np.arange(n), "cpu", image_volumes=inputs["image"].numpy(),
        clinical=inputs["clinical"].numpy(), events=events.numpy(),
        durations=durations.numpy())


def planted_gather_backward(ctx, g):
    """torch.distributed.nn's all-gather backward: the gradient summed
    over the ranks, then this rank's rows."""
    g = g.contiguous().clone()
    torch.distributed.all_reduce(g)
    return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def main(workdir: str) -> int:
    workdir = Path(workdir)
    assert mesh.maybe_initialize_distributed("cpu")
    ranks = mesh.make_mesh([-1], ("data",))
    with np.load(workdir / "spec.npz") as data:
        spec = {k: data[k] for k in data.files}
    flat = {k[len("weights/"):]: v for k, v in spec.items()
            if k.startswith("weights/")}
    results = {}
    for name in [str(c) for c in spec["cases"]]:
        mesh.reset_counts()
        if name == "planted":
            real = mesh._GatherRows.backward
            mesh._GatherRows.backward = staticmethod(planted_gather_backward)
        try:
            got = run_case(name, spec, flat, ranks, workdir)
        finally:
            if name == "planted":
                mesh._GatherRows.backward = real
        results.update({f"{name}/{k}": v for k, v in got.items()})
        results[f"{name}/collectives"] = np.asarray(
            [mesh.counts["all_reduce"], mesh.counts["all_gather"]])
    np.savez(workdir / f"rank{ranks.rank}.npz", **results)
    bad = sorted(k for k in sys.modules if sys.modules[k] is not None
                 and k.split(".")[0] in BLOCKED)
    assert not bad, bad
    torch.distributed.destroy_process_group()
    print(f"rank {ranks.rank} of {ranks.shape[0]}: ok ({os.getpid()})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
