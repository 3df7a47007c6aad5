"""The device phase stamps on the card (``utils/tracing.py``,
``kernels/csrc/span_stamp.cu``): inside a replay of a captured superstep
the stamped span agrees with CUDA events around the replay, and a replay
writes its row with no host launch; a family with no fused bottleneck
(TinyCNN) trains on the card with the stamps, graphed and eager, since
every CUDA training run builds and launches the stamp kernel.

A two-block DenseNet blend model (growth 32) at 32^3, supersteps of 4 x 8,
augmentation and dropout on: a superstep of several milliseconds, so the
few microseconds outside the first and last stamps (the index copy
before the replay, the two row writes after the update) stay far under
1 %. The replay is queued behind a sleep, so the events time the device
and not the host's launch. Skips without a card; it imports no JAX:
``python -m pytest tests/test_torch_tracing_cuda.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from mmnn_sts_torch.data.loader import build_device_dataset
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.models.tinycnn import TinyCNN
from mmnn_sts_torch.ops import fused_dense
from mmnn_sts_torch.train import graphs
from mmnn_sts_torch.train.loop import LoopConfig, train_survival
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import survival_train_epoch
from mmnn_sts_torch.utils import tracing

SIDE, P, A, B, S = 32, 11, 4, 8, 2
WIDE = dict(block_config=(6, 12), growth_rate=32, init_features=64,
            bn_size=4, feature_channels=12, in_channels=2)


@pytest.mark.cuda
def test_cuda_stamped_superstep_agrees_with_events():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel runs only there)")
    rng = np.random.default_rng(0)
    n = S * A * B
    ds = build_device_dataset(
        np.arange(n), "cuda",
        image_volumes=(rng.normal(size=(n,) + (SIDE,) * 3 + (2,)) ** 2
                       * 500).astype(np.float32),
        clinical=rng.normal(size=(n, P)).astype(np.float32),
        events=(rng.random((n, 2)) < 0.7).astype(np.float32),
        durations=rng.integers(1, 4, (n, 2)).astype(np.float32))
    torch.manual_seed(0)
    model = MultiModalModel(DenseNet(**WIDE, out_channels=None,
                                     dropout_prob=0.2), P, num_classes=2,
                            num_features=12, blend=True,
                            clinical_dropout_prob=0.2).cuda()
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 1e-4, S, 20), seed=0)
    idx = np.arange(n).reshape(S, A, B)
    state.ensure_rates(3 * S + 5)  # every step's rate: a grown table binds
    for _ in range(2):  # the warm-up and the capture, then replays
        survival_train_epoch(state, ds, idx, blend=True, augment=True)
    (epoch,) = [v for v in state.graphs.values()
                if isinstance(v, graphs.EpochSteps)]
    step = epoch.graphs["step"]
    assert step.settled
    stamper = epoch.stampers["step"]
    marks = len(stamper.phases) + 1
    assert marks == 4 + 3 * A
    launches = tracing.span_stamp.launches
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gaps = []
    for slot in (0, 1, 0, 1, 0):
        state.begin_step()
        torch.cuda.synchronize()
        # queued behind a sleep: the events time the device, not the host's
        # launch of the replay
        torch.cuda._sleep(50_000_000)
        start.record()
        epoch.run("step", idx[slot], slot)
        end.record()
        torch.cuda.synchronize()
        state.step += 1
        assert step.last == "replay"
        row = epoch.rows.buf[slot, :marks].cpu().numpy()
        assert (np.diff(row) >= 0).all()
        stamped_ms = (row[-1] - row[0]) * 1e-6
        event_ms = start.elapsed_time(end)
        gaps.append(abs(stamped_ms - event_ms) / event_ms)
    assert max(gaps) <= 0.01, gaps
    assert tracing.span_stamp.launches == launches  # replays launch nothing


def _tiny_split(rng, n):
    return build_device_dataset(
        np.arange(n), "cuda",
        image_volumes=(rng.normal(size=(n,) + (16,) * 3 + (2,)) ** 2
                       * 500).astype(np.float32),
        clinical=rng.normal(size=(n, P)).astype(np.float32),
        events=(rng.random((n, 2)) < 0.7).astype(np.float32),
        durations=rng.integers(1, 4, (n, 2)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["graphed", "eager"])
def test_cuda_family_without_the_fused_kernel_trains_with_stamps(tmp_path,
                                                                 fused):
    """TinyCNN has no DenseNet bottleneck: the stamp kernel is the one
    hand-written kernel its training runs. Three epochs of supersteps of
    2 x 2 over 10 volumes (two full supersteps and a masked tail) at 16^3,
    blending: every epoch stamps every superstep (and, graphed, the
    validation forward) with nondecreasing device stamps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel runs only there)")
    tracing.reset()
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    model = MultiModalModel(TinyCNN(in_channels=2, out_channels=None,
                                    feature_channels=4, dropout_prob=0.2),
                            P, num_classes=2, num_features=4, blend=True,
                            clinical_dropout_prob=0.2).cuda()
    state = create_train_state(model, *make_optimizer(
        model.parameters(), 1e-3, 3, 3), seed=0)
    cfg = LoopConfig(epochs=3, batch_size=2, super_batch=4, blend=True,
                     blend_update_interval=1, output_dir=str(tmp_path),
                     save_params_name="best.npz", fused_epoch=fused)
    fused_launches = fused_dense.fused_bn_relu_matmul.launches
    stamp_launches = tracing.span_stamp.launches
    train_survival(state, _tiny_split(rng, 10), _tiny_split(rng, 5), cfg)
    recs = tracing.records()
    tracing.reset()
    assert fused_dense.fused_bn_relu_matmul.launches == fused_launches
    assert tracing.span_stamp.launches > stamp_launches
    kinds = ["step", "step", "tail"] + (["val"] if fused else [])
    assert sorted(recs) == [0, 1, 2]
    for rec in recs.values():
        assert [r["kind"] for r in rec["phases"]] == kinds
        for r in rec["phases"]:
            marks = np.array(r["marks"])
            assert len(marks) == len(r["phases"]) + 1
            assert marks[0] > 0 and (np.diff(marks) >= 0).all()
