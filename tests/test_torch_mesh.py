"""The port's ``data`` mesh (``parallel/mesh.py``) on the CPU: two gloo
ranks, each a subprocess (``tests/test_torch_mesh_ranks.py``, with jax,
flax, pandas, matplotlib and yaml blocked; this pytest process imports jax),
held against the one-process port and against the JAX package on a
2-device ``data`` mesh (tests/conftest.py's virtual CPU devices) from the
same weights and global batches.

The model is the narrow multimodal blend model of
tests/test_torch_train_steps.py (TinyDenseNet, growth 8, at 16^3 x 2ch,
plus the 11-input clinical MLP), each microbatch of B = 4 split into two
rows a rank. Cases: the survival superstep (A = 2, Efron, a ragged masked
second microbatch), the same superstep with the augmentation and dropout
0.2 on (the ranks draw the whole microbatch's randomness and keep their
rows, so they equal the one-process run on the same generator), the
classification step (ragged), a fused epoch (``survival_train_epoch``: two
supersteps, the masked tail and the validation forward), the loop's files,
and a planted fault: the output gather's backward summing the gradient
over the ranks, as ``torch.distributed.nn.functional.all_gather`` does.

Tolerances are the superstep twin's (tests/test_torch_train_steps.py):
loss, predictions and BatchNorm statistics rtol/atol 1e-4 (1e-3 for the
epoch's later steps, which run on weights its updates moved); the update
(new - old) in relative L2 within 3e-2 a tensor and 1e-2 over all, the
control set by that file's one-ulp run. The two ranks must agree with
each other bit for bit. A world of one rank (gloo, in this process)
equals the run without a process group bit for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as JP

import test_torch_mesh_ranks as ranks_prog
from mmnn_sts_tpu.models.densenet import tiny_densenet as jax_tiny_densenet
from mmnn_sts_tpu.models.multimodal import MultiModalModel as JaxMultiModal
from mmnn_sts_tpu.parallel.mesh import replicate
from mmnn_sts_tpu.train.schedule import make_optimizer as jax_make_optimizer
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from mmnn_sts_tpu.train.steps import (
    classification_train_step as jax_class_step,
    survival_train_superstep as jax_superstep)
from mmnn_sts_torch.exceptions import ConfigurationError
from mmnn_sts_torch.parallel import mesh
from mmnn_sts_torch.train import graphs
from mmnn_sts_torch.train.steps import (
    classification_train_step, survival_train_superstep)
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
A, B, SIDE, P = 2, 4, 16, ranks_prog.P
TOL = dict(rtol=1e-4, atol=1e-4)
# the epoch's later steps run on weights its earlier updates moved, and an
# update moves by 2e-2 in relative L2 under a one-ulp change of its input
# (tests/test_torch_train_steps.py): measured 1.7e-4 here
EPOCH_TOL = dict(rtol=1e-3, atol=1e-3)
UPDATE_TOL, UPDATE_TOL_ALL = 3e-2, 1e-2
CASES = ("survival", "survival_random", "planted", "classification",
         "epoch", "loop", "inference", "planar")
SPLIT = 12  # resident training split of the epoch and loop cases


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(rng, lead):
    return {"image": (rng.normal(size=lead + (SIDE,) * 3 + (2,)) ** 2
                      * 500).astype(np.float32),
            "clinical": rng.normal(size=lead + (P,)).astype(np.float32),
            "events": (rng.random(lead + (2,)) < 0.7).astype(np.float32),
            "durations": rng.integers(1, 4, lead + (2,)).astype(np.float32)}


def _jax_state():
    image = jax_tiny_densenet(**ranks_prog.TINY, out_channels=2,
                              dropout_prob=0.0)
    model = JaxMultiModal(image_model=image, num_clinical_inputs=P,
                          num_classes=2, num_features=4, blend=True,
                          clinical_dropout_prob=0.0)
    sample = {"image": jnp.zeros((B,) + (SIDE,) * 3 + (2,)),
              "clinical": jnp.zeros((B, P))}
    state = jax_create_state(
        model, jax_make_optimizer(ranks_prog.LR, ranks_prog.STEPS_PER_EPOCH,
                                  ranks_prog.EPOCHS), sample, seed=0)
    flat = randomise(jax_flat({"params": state.params,
                               "batch_stats": state.batch_stats}), seed=3)
    variables = jax_variables(flat)
    return state.replace(params=variables["params"],
                         batch_stats=variables["batch_stats"]), flat


def _spec(flat) -> dict:
    rng = np.random.default_rng(7)
    spec = {f"weights/{k}": v for k, v in flat.items()}
    surv = _batch(rng, (A, B))
    surv["mask"] = np.asarray([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    spec.update({f"survival/{k}": v for k, v in surv.items()})
    cls = _batch(rng, (B,))
    cls["labels"] = (rng.random((B, 2)) < 0.5).astype(np.float32)
    cls["mask"] = np.asarray([1, 1, 1, 0], np.float32)
    spec.update({f"classification/{k}": v for k, v in cls.items()})
    spec.update({f"train/{k}": v for k, v in _batch(rng, (SPLIT,)).items()})
    spec.update({f"val/{k}": v for k, v in _batch(rng, (5,)).items()})
    order = rng.permutation(SPLIT)
    spec["epoch/idx"] = order[:8].reshape(1, A, B)
    spec["epoch/tail_idx"] = np.concatenate([order[8:], order[:4]]).reshape(
        A, B)
    spec["epoch/tail_mask"] = np.asarray([[1] * 4, [0] * 4], np.float32)
    spec["planar/image"] = rng.normal(size=(2, 24, 24, 2)).astype(np.float32)
    spec["cases"] = np.asarray(CASES)
    return spec


def _jax_two_devices(spec):
    """The JAX package's superstep and classification step with each
    microbatch's rows sharded over a 2-device ``data`` mesh (each from a
    fresh state: a JAX step donates the one it is given)."""
    jmesh = JaxMesh(np.asarray(jax.devices()[:2]), ("data",))

    def fresh():
        jstate = _jax_state()[0]
        return jstate.replace(
            params=replicate(jmesh, jstate.params),
            batch_stats=replicate(jmesh, jstate.batch_stats),
            opt_state=replicate(jmesh, jstate.opt_state))

    st = fresh()

    def put(x, spec_):
        return jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec_))

    s = {k[len("survival/"):]: v for k, v in spec.items()
         if k.startswith("survival/")}
    lead = JP(None, "data")
    new, aux = jax_superstep(
        st, {"image": put(s["image"], lead),
             "clinical": put(s["clinical"], lead)},
        put(s["events"], lead), put(s["durations"], lead), jax.random.key(0),
        blend=True, augment=False, ties="efron", mask=put(s["mask"], lead))
    out = {"survival/loss": np.asarray(aux["loss"]),
           "survival/preds": np.asarray(aux["preds"])}
    out.update({f"survival/after/{k}": v for k, v in jax_flat(
        {"params": new.params, "batch_stats": new.batch_stats}).items()})
    c = {k[len("classification/"):]: v for k, v in spec.items()
         if k.startswith("classification/")}
    rows = JP("data")
    st = fresh()
    new, aux = jax_class_step(
        st, {"image": put(c["image"], rows),
             "clinical": put(c["clinical"], rows)},
        put(c["labels"], rows), jnp.full((2,), 1.5), jax.random.key(0),
        blend=True, augment=False, mask=put(c["mask"], rows))
    out["classification/loss"] = np.asarray(aux["loss"])
    out["classification/preds"] = np.asarray(aux["preds"])
    out.update({f"classification/after/{k}": v for k, v in jax_flat(
        {"params": new.params, "batch_stats": new.batch_stats}).items()})
    return out


def _one_process(spec, flat, workdir):
    out = {}
    for name in CASES:
        if name in ("loop", "planted"):
            continue  # the loop's files are the ranks' own check
        got = ranks_prog.run_case(name, spec, flat, None, workdir)
        out.update({f"{name}/{k}": v for k, v in got.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(initial weights, each rank's results, the one-process port's, the
    JAX 2-device mesh's, the work directory)."""
    work = tmp_path_factory.mktemp("mesh")
    flat = _jax_state()[1]
    spec = _spec(flat)
    np.savez(work / "spec.npz", **spec)
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{REPO / 'tests'}",
           "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "test_torch_mesh_ranks.py"),
         str(work)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    # the references while the ranks run
    one = _one_process(spec, flat, work / "one")
    two_devices = _jax_two_devices(spec)
    logs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "ok" in out, (r, out, err[-4000:])
    got = []
    for r in range(2):
        with np.load(work / f"rank{r}.npz") as data:
            got.append({k: data[k] for k in data.files})
    return flat, got, one, two_devices, work


def _update_err(before, got, want, prefix):
    """Relative L2 of the update over every parameter, and the worst
    tensor's; BatchNorm statistics elementwise."""
    deltas_g, deltas_w, worst = [], [], 0.0
    for key, old in before.items():
        new_g = got[f"{prefix}/after/{key}"]
        new_w = want[f"{prefix}/after/{key}"]
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(new_g, new_w, **TOL, err_msg=key)
            continue
        dg, dw = new_g - old, new_w - old
        if np.linalg.norm(dw) > 0:
            worst = max(worst, np.linalg.norm(dg - dw) / np.linalg.norm(dw))
        deltas_g.append(dg.ravel())
        deltas_w.append(dw.ravel())
    dg, dw = np.concatenate(deltas_g), np.concatenate(deltas_w)
    return np.linalg.norm(dg - dw) / np.linalg.norm(dw), worst


def _check(runs, case, against):
    before, got, one, jax_out, _ = runs
    want = one if against == "port" else jax_out
    rank0 = got[0]
    tol = EPOCH_TOL if case == "epoch" else TOL
    np.testing.assert_allclose(rank0[f"{case}/loss"], want[f"{case}/loss"],
                               **tol)
    np.testing.assert_allclose(rank0[f"{case}/preds"],
                               want[f"{case}/preds"], **tol)
    if case == "epoch":  # its first superstep is a superstep like the others
        np.testing.assert_allclose(rank0[f"{case}/preds"][0],
                                   want[f"{case}/preds"][0], **TOL)
    err, worst = _update_err(before, rank0, want, case)
    print(f"{case} vs {against}: update rel L2 {err:.2e}, worst tensor "
          f"{worst:.2e}")
    assert err <= UPDATE_TOL_ALL and worst <= UPDATE_TOL, (err, worst)


@pytest.mark.parametrize("case", ["survival", "survival_random",
                                  "classification", "epoch"])
def test_two_ranks_match_the_one_process_port(runs, case):
    _check(runs, case, "port")
    if case == "epoch":
        _, got, one, _, _ = runs
        for key in ("val_preds", "val_loss"):
            np.testing.assert_allclose(got[0][f"epoch/{key}"],
                                       one[f"epoch/{key}"], **EPOCH_TOL)


@pytest.mark.parametrize("case", ["survival", "classification"])
def test_two_ranks_match_jax_on_a_two_device_mesh(runs, case):
    _check(runs, case, "jax")


@pytest.mark.parametrize("case", [c for c in CASES if c != "loop"])
def test_the_ranks_agree_bit_for_bit(runs, case):
    """Every rank holds the same loss, predictions and weights."""
    got = runs[1]
    keys = [k for k in got[0] if k.startswith(case + "/")
            and not k.endswith("/collectives")]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)


def test_collectives_per_step(runs):
    """One all-reduce per train-mode BatchNorm forward and backward, one
    output gather a microbatch, one gradient sum a step."""
    from mmnn_sts_torch.models.common import BatchNorm
    from mmnn_sts_torch.models.densenet import FusedBottleneck

    before, got = runs[0], runs[1][0]
    model = ranks_prog.build_state(before, None).model
    norms = sum(isinstance(m, (BatchNorm, FusedBottleneck))
                for m in model.modules())
    assert tuple(got["survival/collectives"]) == (A * 2 * norms + 1, A)
    assert tuple(got["classification/collectives"]) == (2 * norms + 1, 1)


def test_gathered_loss_gradient_is_not_scaled_by_the_world(runs):
    """The planted fault (the gather's backward summing the gradient over
    the ranks) moves the update far outside the tolerance: the check above
    would catch an autograd all-gather that scales by the world size."""
    before, got, one, _, _ = runs
    err, _ = _update_err(before, {k.replace("planted/", "survival/", 1): v
                                  for k, v in got[0].items()
                                  if k.startswith("planted/")}, one,
                         "survival")
    print(f"planted gather backward vs one process: update rel L2 {err:.2e}")
    assert err > 10 * UPDATE_TOL_ALL


def test_only_rank_0_writes_files(runs):
    work = runs[4]
    written = {r: sorted(str(p.relative_to(work / f"rank{r}"))
                         for p in (work / f"rank{r}").rglob("*")
                         if p.is_file())
               for r in range(2)}
    assert written[1] == [], written[1]
    assert {"out/metrics.jsonl", "out/best.npz",
            "ckpt/index.json"} <= set(written[0]), written[0]


def test_inference_under_two_ranks_writes_the_one_rank_csv(runs):
    """``inference_survival`` sharded over two ranks: rank 0 alone writes
    survival_model_predictions.csv, whose rows are the one-process run's
    (its predictions within 1e-6: the eval forward sees other batch
    sizes)."""
    work, got, one = runs[4], runs[1], runs[2]
    np.testing.assert_allclose(got[0]["inference/preds"],
                               one["inference/preds"], rtol=1e-6, atol=1e-6)
    assert not [p for p in (work / "rank1" / "infer").iterdir()]
    rows = (work / "rank0" / "infer" / "survival_model_predictions.csv"
            ).read_text().splitlines()
    want = (work / "one" / "rank0" / "infer" /
            "survival_model_predictions.csv").read_text().splitlines()
    assert rows[0] == want[0] and len(rows) == len(want) == 6
    for a, b in zip(rows[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(a.split(","), float),
                                   np.asarray(b.split(","), float),
                                   rtol=1e-5, atol=1e-6)


def test_planar_forward_runs_without_jax(runs):
    """The rank subprocesses (jax, flax, pandas, matplotlib and yaml
    blocked) ran a 2D TinyCNN forward; it equals this process's."""
    _, got, one, _, _ = runs
    np.testing.assert_array_equal(got[0]["planar/preds"],
                                  one["planar/preds"])
    assert got[0]["planar/preds"].shape == (2, 2)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield mesh.make_mesh([-1], ("data",))
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_bit_equal_to_no_process_group(world_of_one):
    """The superstep (augmentation, dropout 0.2 and a ragged mask) and the
    classification step through the collectives of a world of one equal
    the steps without a process group, in every tensor."""
    _, flat = _jax_state()
    spec = _spec(flat)
    assert world_of_one.backend == "gloo" and world_of_one.shape == (1,)
    results = []
    for ranks in (world_of_one, None):
        mesh.reset_counts()
        inputs, events, durations, _, mask = ranks_prog.batch(spec,
                                                              "survival")
        state = ranks_prog.build_state(flat, ranks, dropout=0.2)
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, mask=mask)
        inputs, _, _, labels, mask = ranks_prog.batch(spec, "classification")
        cls = classification_train_step(state, inputs, labels,
                                        torch.full((2,), 1.5), blend=True,
                                        mask=mask)
        grads = [p.grad.clone() for p in state.model.parameters()]
        results.append((aux, cls, state.model.state_dict(), grads,
                        dict(mesh.counts)))
    (aux1, cls1, sd1, g1, n1), (aux0, cls0, sd0, g0, n0) = results
    assert n1["all_gather"] == A + 1 and n1["all_reduce"] > 2
    assert n0 == {"all_reduce": 0, "all_gather": 0}
    for a, b in ((aux1, aux0), (cls1, cls0)):
        for key in ("loss", "preds"):
            assert torch.equal(a[key], b[key]), key
    for key in sd0:
        assert torch.equal(sd1[key], sd0[key]), key
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_make_mesh_covers_the_world_and_fused_epoch_needs_nccl_on_a_card(
        world_of_one):
    """Shapes over the ranks as JAX's over its devices (-1 takes the
    rest); the data axis reads the mesh; a gloo group on a card refuses
    the CUDA graphs of TPU.fused_epoch."""
    assert mesh.make_mesh().shape == (1,)
    assert mesh.make_mesh([1, -1], ("data", "model")).shape == (1, 1)
    for shape in ([2], [-1, 4]):
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            mesh.make_mesh(shape)
    assert mesh.data_axis_size(world_of_one) == 1
    assert mesh.data_shard(world_of_one, 4) == mesh.DataShard(1, 0)
    assert mesh.data_shard(None, 4) is None
    assert mesh.choose_backend(torch.device("cpu"), 1) == "gloo"

    class OnACard:
        device = torch.device("cuda", 0)
        mesh = world_of_one

    with pytest.raises(ConfigurationError, match="gloo"):
        graphs.epoch_steps(OnACard, "key", None, (), (A, B), 1, None)
