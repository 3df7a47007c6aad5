"""The data axis of ``TPU.mesh_shape`` and ``spatial_dims: 2`` on the card:
the twins of ``chip_smoke.py``'s mesh phase (a) and planar phase at a small
size. Skips without a card; it imports no JAX, so it also runs where JAX
is not installed: ``python -m pytest tests/test_torch_mesh_cuda.py -m cuda
--noconftest``.

* One rank over NCCL in this process (a FileStore): two eager supersteps
  and two through ``survival_train_epoch`` (the warm-up, then the capture
  and its replay), from the same state as the run without a process
  group, equal in every tensor (cuDNN deterministic, TF32 off); a gloo
  group on the card refuses the graphs.
* A narrow 2D DenseNet blend model and TinyCNN on the card against the
  CPU (eval forward within 1e-4 x max(1, |CPU|)), the kernel launched once
  a bottleneck.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmnn_sts_torch.data.loader import build_device_dataset, gather_superbatch
from mmnn_sts_torch.exceptions import ConfigurationError
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.models.tinycnn import TinyCNN
from mmnn_sts_torch.ops import fused_dense
from mmnn_sts_torch.parallel import mesh
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    survival_train_epoch, survival_train_superstep)

SIDE, P, A, B, N = 16, 11, 2, 4, 8
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the kernel run only "
                    "there)")


def _model(spatial_dims=3):
    torch.manual_seed(0)
    return MultiModalModel(DenseNet(**NARROW, out_channels=None,
                                    dropout_prob=0.2,
                                    spatial_dims=spatial_dims), P,
                           num_classes=2, num_features=4, blend=True,
                           clinical_dropout_prob=0.2)


def _state(ranks=None):
    model = _model().cuda()
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 2e-3, 4, 2), seed=0, mesh=ranks)
    state.ensure_rates(8)
    return state


def _split():
    rng = np.random.default_rng(5)
    return build_device_dataset(
        np.arange(N), "cuda",
        image_volumes=(rng.normal(size=(N,) + (SIDE,) * 3 + (2,)) ** 2
                       * 500).astype(np.float32),
        clinical=rng.normal(size=(N, P)).astype(np.float32),
        events=(rng.random((N, 2)) < 0.7).astype(np.float32),
        durations=rng.integers(1, 4, (N, 2)).astype(np.float32))


def _run(state, ds, idx, graphed):
    out = []
    for row in idx:
        if graphed:
            res = survival_train_epoch(state, ds, row[None], blend=True)
            out += [res["loss"][0].clone(), res["preds"][0].clone()]
        else:
            batch = gather_superbatch(ds, row)
            res = survival_train_superstep(
                state, batch["inputs"], batch["events"], batch["durations"],
                blend=True)
            out += [res["loss"], res["preds"]]
    out += [p.detach() for p in state.model.parameters()]
    out += list(state.model.buffers()) + state.momentum_buffers()
    out.append(state.generator.get_state())
    return out


@pytest.fixture
def deterministic():
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    yield
    cudnn.allow_tf32, cudnn.deterministic = before


@pytest.mark.cuda
def test_cuda_one_nccl_rank_is_bit_equal_eager_and_graphed(
        tmp_path, monkeypatch, deterministic):
    _needs_card()
    ds = _split()
    rng = np.random.default_rng(6)
    idx = np.stack([rng.permutation(N).reshape(A, B) for _ in range(2)])
    want = _run(_state(), ds, idx, False)
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "LOCAL_WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(key, value)
    assert mesh.maybe_initialize_distributed(
        "cuda", init_method=f"file://{tmp_path}/store")
    try:
        ranks = mesh.make_mesh([-1], ("data",))
        assert ranks.backend == "nccl"
        mesh.reset_counts()
        eager = _run(_state(ranks), ds, idx, False)
        assert mesh.counts["all_gather"] == 2 * A
        graphed_state = _state(ranks)
        graphed = _run(graphed_state, ds, idx, True)
        (steps,) = graphed_state.graphs.values()
        assert steps.graphs["step"].replays == 1
    finally:
        dist.destroy_process_group()
    for got in (eager, graphed):
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_gloo_on_a_card_refuses_the_graphs(tmp_path):
    _needs_card()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        state = _state(mesh.make_mesh())
        with pytest.raises(ConfigurationError, match="gloo"):
            survival_train_epoch(state, _split(),
                                 np.arange(A * B).reshape(1, A, B),
                                 blend=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["densenet", "tinycnn"])
def test_cuda_planar_forward_matches_the_cpu(name, deterministic):
    _needs_card()
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.random((4, 32, 32, 2)).astype(np.float32))
    if name == "densenet":
        model = _model(spatial_dims=2).eval()
        inputs = {"image": image, "clinical": torch.from_numpy(
            rng.normal(size=(4, P)).astype(np.float32))}
    else:
        torch.manual_seed(0)
        model = TinyCNN(in_channels=2, out_channels=2, spatial_dims=2).eval()
        inputs = image
    with torch.no_grad():
        want = model(inputs)
        card = model.cuda()
        fused_dense.fused_bn_relu_matmul.launches = 0
        got = card({k: v.cuda() for k, v in inputs.items()}
                   if isinstance(inputs, dict) else inputs.cuda()).cpu()
    assert fused_dense.fused_bn_relu_matmul.launches == (
        4 if name == "densenet" else 0)
    limit = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= limit
