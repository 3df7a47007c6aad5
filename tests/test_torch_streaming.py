"""``TPU.device_resident_dataset: false`` in the port: the host-resident
split (``data/streaming.HostDataset``), ``prefetched_epoch``, chunked
evaluation of a host split (``train/evaluate.py``), the loop and the CLI
streaming from it, and inference over it.

* ``prefetched_epoch`` against the JAX package's on the same host split:
  every batch, the same values (tests/test_streaming.py:22-48).
* Chunked evaluation of a host split: the default chunk of 64
  (``resolve_chunk``), the same predictions chunked and whole, the
  classification loss the same sum, and both against the JAX package's
  chunked evaluation of its own host split within 1e-5 (float32, a
  clinical MLP); a host validation split larger than a chunk trains and
  validates (tests/test_loop_stats.py:109-176).
* The loop from host splits against the same loop from resident ones, with
  augmentation and dropout on: the same history and weights bit for bit
  (the batches are the same rows; prefetching moves only copies). With
  ``fused_epoch`` a host split takes the per-superstep path, as in JAX.
* ``python -m mmnn_sts_torch`` with ``"TPU": {"device_resident_dataset":
  false}`` on ``--device cpu``: the resident run's metrics, and
  ``--inference`` (chunks of 4, Grad-CAM a patient at a time) the resident
  inference's predictions within 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmnn_sts_torch.convert import load_jax_npz
from mmnn_sts_torch.data.loader import EpochBatcher, build_device_dataset
from mmnn_sts_torch.data.streaming import (
    HostDataset, build_host_dataset, prefetched_epoch)
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.mlp import MLP
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.train.evaluate import (
    DEFAULT_EVAL_CHUNK, classification_eval_split, resolve_chunk,
    survival_eval_split)
from mmnn_sts_torch.train.loop import (
    LoopConfig, train_classification, train_survival)
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_tpu.data.loader import EpochBatcher as JaxEpochBatcher
from mmnn_sts_tpu.data.streaming import HostDataset as JaxHostDataset
from mmnn_sts_tpu.data.streaming import prefetched_epoch as jax_prefetched
from mmnn_sts_tpu.models.mlp import MLP as JaxMLP
from mmnn_sts_tpu.parallel.mesh import make_mesh
from mmnn_sts_tpu.train.evaluate import \
    survival_eval_split as jax_survival_eval_split
from mmnn_sts_tpu.train.state import create_train_state as jax_create_state
from test_torch_convert import jax_flat

torch.set_num_threads(1)

F, SIDE, P = 5, 16, 11
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)


def _clinical(seed, n, survival=True):
    rng = np.random.default_rng(seed)
    arrays = {"clinical": rng.normal(size=(n, F)).astype(np.float32)}
    if survival:
        arrays["events"] = (rng.random((n, 2)) < 0.7).astype(np.float32)
        arrays["durations"] = rng.integers(1, 100, (n, 2)).astype(np.float32)
    else:
        arrays["labels"] = (rng.random((n, 2)) < 0.5).astype(np.float32)
    return arrays


@pytest.mark.parametrize("accum", [1, 2])
def test_prefetched_epoch_matches_jax(accum):
    arrays = _clinical(0, 20)
    ds = build_host_dataset(np.arange(20), "cpu", **arrays)
    jds = JaxHostDataset(uids=np.arange(20),
                         inputs={"clinical": arrays["clinical"]},
                         events=arrays["events"],
                         durations=arrays["durations"])
    batcher = EpochBatcher(20, micro_batch=4, accum_steps=accum, seed=3)
    jbatcher = JaxEpochBatcher(20, micro_batch=4, accum_steps=accum, seed=3)
    got = list(prefetched_epoch(ds, batcher, epoch=1))
    want = list(jax_prefetched(jds, jbatcher, 1, make_mesh()))
    assert len(got) == len(want) == batcher.steps_per_epoch()
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    assert got[0]["inputs"].shape == ((2, 4, F) if accum == 2 else (4, F))
    # the split stays on the host
    assert isinstance(ds, HostDataset) and ds.inputs["clinical"].device.type \
        == "cpu"


def _mlp_pair(survival=True):
    jm = JaxMLP(in_channels=F, out_channels=2, feature_channels=4,
                dropout_prob=0.0)
    jstate = jax_create_state(jm, optax.sgd(1e-2), jnp.zeros((2, F)), seed=0)
    flat = jax_flat({"params": jstate.params,
                     "batch_stats": jstate.batch_stats})
    model = MLP(in_channels=F, out_channels=2, feature_channels=4,
                dropout_prob=0.0)
    load_jax_npz(model, flat)
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 1e-2, 2, 2), seed=0)
    return jstate, state


def test_survival_eval_of_a_host_split_in_chunks():
    arrays = _clinical(1, 10)
    host = build_host_dataset(np.arange(10), "cpu", **arrays)
    resident = build_device_dataset(np.arange(10), "cpu", **arrays)
    assert resolve_chunk(host) == DEFAULT_EVAL_CHUNK == 64
    assert resolve_chunk(resident) == 0 and resolve_chunk(host, 4) == 4
    jstate, state = _mlp_pair()
    whole = survival_eval_split(state, resident, blend=False, ties="breslow")
    # the default chunk holds the whole split: the same program's numbers
    default = survival_eval_split(state, host, blend=False, ties="breslow")
    assert np.array_equal(default["preds"], whole["preds"])
    assert default["loss"] == whole["loss"]
    chunked = survival_eval_split(state, host, blend=False, ties="breslow",
                                  chunk=4)
    np.testing.assert_allclose(chunked["preds"], whole["preds"], rtol=1e-6,
                               atol=1e-6)
    jds = JaxHostDataset(uids=np.arange(10),
                         inputs={"clinical": arrays["clinical"]},
                         events=arrays["events"],
                         durations=arrays["durations"])
    want = jax_survival_eval_split(jstate, jds, blend=False, ties="breslow",
                                   chunk=4)
    np.testing.assert_allclose(chunked["preds"], want["preds"], rtol=1e-5,
                               atol=1e-5)
    for key in ("loss", "selection_loss"):
        assert chunked[key] == pytest.approx(want[key], rel=1e-5)


def test_classification_eval_of_a_host_split_in_chunks():
    arrays = _clinical(2, 11, survival=False)
    host = build_host_dataset(np.arange(11), "cpu", **arrays)
    _, state = _mlp_pair()
    pw = torch.ones(2)
    whole = classification_eval_split(state, host, pw, blend=False,
                                      chunk=100)
    chunked = classification_eval_split(state, host, pw, blend=False,
                                        chunk=4)
    np.testing.assert_allclose(chunked["preds"], whole["preds"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(chunked["elementwise"], whole["elementwise"],
                               rtol=1e-6, atol=1e-6)
    assert chunked["loss"] == pytest.approx(whole["loss"], rel=1e-5)


def test_host_validation_split_larger_than_a_chunk(tmp_path):
    train = build_device_dataset(np.arange(8), "cpu", **_clinical(3, 8))
    val = build_host_dataset(np.arange(20), "cpu", **_clinical(4, 20))
    _, state = _mlp_pair()
    cfg = LoopConfig(epochs=2, batch_size=4, super_batch=4, seed=0,
                     output_dir=str(tmp_path), augment=False, eval_chunk=8)
    result = train_survival(state, train, val, cfg)
    assert len(result.history["val_loss"]) == 2
    assert all(np.isfinite(v) for v in result.history["val_loss"])


def _image_split(seed, n, survival):
    rng = np.random.default_rng(seed)
    arrays = {"image_volumes": (rng.normal(size=(n,) + (SIDE,) * 3 + (2,))
                                ** 2 * 500).astype(np.float32),
              "clinical": rng.normal(size=(n, P)).astype(np.float32)}
    if survival:
        arrays["events"] = (rng.random((n, 2)) < 0.7).astype(np.float32)
        arrays["durations"] = rng.integers(1, 4, (n, 2)).astype(np.float32)
    else:
        arrays["labels"] = (rng.random((n, 2)) < 0.5).astype(np.float32)
    return arrays


def _blend_state():
    torch.manual_seed(0)
    encoder = DenseNet(**NARROW, out_channels=None, dropout_prob=0.2)
    model = MultiModalModel(encoder, P, num_classes=2, num_features=4,
                            blend=True, clinical_dropout_prob=0.2)
    return create_train_state(model, *make_optimizer(
        model.parameters(), 2e-3, 3, 2), seed=0)


@pytest.mark.parametrize("survival", [True, False],
                         ids=["survival", "classification"])
def test_loop_from_host_splits_is_the_resident_loop(tmp_path, survival):
    """Two epochs, augmentation and dropout on, a blend update each: the
    host splits train on the same bits. fused_epoch on a host split takes
    the per-superstep path (no step body is bound)."""
    train, val = _image_split(5, 10, survival), _image_split(6, 5, survival)
    runs = {}
    for name, build in (("resident", build_device_dataset),
                        ("host", build_host_dataset)):
        state = _blend_state()
        cfg = LoopConfig(epochs=2, batch_size=2 if survival else 4,
                         super_batch=4, blend=True, blend_update_interval=1,
                         seed=1, output_dir=str(tmp_path / name),
                         augment=True, fused_epoch=name == "host")
        loop = train_survival if survival else train_classification
        runs[name] = loop(state, build(np.arange(10), "cpu", **train),
                          build(np.arange(5), "cpu", **val), cfg)
    host, resident = runs["host"], runs["resident"]
    assert host.history == resident.history
    assert not host.state.graphs
    for (n, p), q in zip(resident.state.model.state_dict().items(),
                         host.state.model.state_dict().values()):
        assert torch.equal(p, q), n
    assert torch.equal(host.state.generator.get_state(),
                       resident.state.generator.get_state())


@pytest.fixture(scope="module")
def cli_cohort(tmp_path_factory):
    from fixtures import make_full_cohort

    root = tmp_path_factory.mktemp("cohort")
    paths, _ = make_full_cohort(str(root), n=40)
    return {"Data": {"data_loc": paths["clinical"],
                     "image_loc": paths["root"], "key_loc": paths["key"]},
            "ImageModel": {"name": "tinydensenet",
                           "spatial_size": [SIDE] * 3},
            "Hyperparameters": {"train_batch_size": 4}}


def test_cli_streams_from_the_host_on_cpu(cli_cohort, tmp_path, monkeypatch):
    """Training with ``device_resident_dataset: false`` gives the resident
    run's metrics; ``--inference`` over the host test split in chunks of 4
    (Grad-CAM a patient at a time) gives the resident inference's
    predictions."""
    from mmnn_sts_torch.cli import main

    monkeypatch.chdir(tmp_path)
    rows, preds = {}, {}
    for resident in (True, False):
        cfg = {**cli_cohort, "TPU": {"device_resident_dataset": resident}}
        path = tmp_path / f"cfg_{resident}.json"
        path.write_text(json.dumps(cfg))
        out = tmp_path / f"out_{resident}"
        assert main(["--images", "--preop", "--survival", "--blend",
                     "--split", "--config", str(path), "--output_path",
                     str(out), "--epochs", "2", "--device", "cpu"]) == 0
        rows[resident] = [
            {k: v for k, v in json.loads(x).items()
             if k not in ("epoch_seconds", "samples_per_sec", "ts")}
            for x in (out / "metrics.jsonl").read_text().splitlines()]
        cfg["TPU"]["eval_chunk_size"] = 0 if resident else 4
        cfg["Hyperparameters"]["model_weights"] = str(
            tmp_path / "out_True" / "best_surv_model.npz")
        cfg["Preprocessing"] = {f"{s}_uid_location": str(
            tmp_path / f"{s}_uids.txt") for s in ("train", "val", "test")}
        path.write_text(json.dumps(cfg))
        infer = tmp_path / f"infer_{resident}"
        assert main(["--inference", "--images", "--preop", "--survival",
                     "--blend", "--config", str(path), "--output_path",
                     str(infer), "--device", "cpu"]) == 0
        preds[resident] = np.loadtxt(
            infer / "survival_model_predictions.csv", delimiter=",",
            skiprows=1)
        assert len(list((infer / "attention_maps").iterdir())) == len(
            preds[resident])
    assert rows[False] == rows[True]
    np.testing.assert_allclose(preds[False], preds[True], rtol=1e-5,
                               atol=1e-5)
