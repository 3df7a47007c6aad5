"""``TPU.fused_epoch`` on the card (``train/graphs.py``): the epoch
functions' CUDA graphs against the same supersteps run eagerly, and a
capture that fails.

A narrow two-block DenseNet blend model (growth 8) at 16^3 with seeded
weights, dropout 0.2 and the augmentation on, cuDNN's TF32 off and its
deterministic algorithms on (its default weight gradients add with
atomics): each graphed epoch is held against the same epoch run eagerly
from the same state, bit-equal or within 1e-5 x max(1, |eager|) per
tensor, the generator's state and the step equal. Skips without a card;
it imports no JAX, so it also runs where JAX is not installed: ``python -m
pytest tests/test_torch_fused_epoch_cuda.py -m cuda --noconftest``.
"""

import gc

import numpy as np
import pytest
import torch

from mmnn_sts_torch.data.loader import (
    EpochBatcher, build_device_dataset, gather_superbatch)
from mmnn_sts_torch.models.common import CHANNELS_LAST, max_pool
from mmnn_sts_torch.models.densenet import DenseNet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.train import graphs, steps
from mmnn_sts_torch.train.schedule import make_optimizer
from mmnn_sts_torch.train.state import create_train_state
from mmnn_sts_torch.train.steps import (
    survival_eval_step, survival_train_epoch, survival_train_superstep)

SIDE, P, A, B, N, N_VAL = 16, 11, 2, 2, 6, 5
NARROW = dict(block_config=(2, 2), growth_rate=8, init_features=16,
              bn_size=2, feature_channels=4, in_channels=2)


def _split(seed, n):
    rng = np.random.default_rng(seed)
    return build_device_dataset(
        np.arange(n), "cuda",
        image_volumes=(rng.normal(size=(n,) + (SIDE,) * 3 + (2,)) ** 2
                       * 500).astype(np.float32),
        clinical=rng.normal(size=(n, P)).astype(np.float32),
        events=(rng.random((n, 2)) < 0.7).astype(np.float32),
        durations=rng.integers(1, 4, (n, 2)).astype(np.float32))


def _state():
    torch.manual_seed(0)
    model = MultiModalModel(DenseNet(**NARROW, out_channels=None,
                                     dropout_prob=0.2), P, num_classes=2,
                            num_features=4, blend=True,
                            clinical_dropout_prob=0.2).cuda()
    return create_train_state(model, *make_optimizer(
        model.parameters(), 2e-3, 4, 2), seed=0)


def _rows(epoch):
    batcher = EpochBatcher(N, B, A, seed=0, two_level=True)
    order = batcher.epoch_indices(epoch)
    return order[:-1], order[-1], batcher.pad_mask()[-1]


def _loop(state, ds, val, idx, tail, mask):
    losses, preds = [], []
    for step_idx, m in [(i, None) for i in idx] + [(tail, mask)]:
        batch = gather_superbatch(ds, step_idx)
        aux = survival_train_superstep(
            state, batch["inputs"], batch["events"], batch["durations"],
            blend=True, augment=True, mask=m)
        losses.append(aux["loss"])
        preds.append(aux["preds"])
    ev = survival_eval_step(state, val.model_inputs(), val.events,
                            val.durations, blend=True)
    return {"loss": torch.stack(losses), "preds": torch.stack(preds),
            "val_preds": ev["preds"], "val_loss": ev["loss"],
            "val_selection": ev["selection_loss"]}


def _everything(state, out: dict) -> dict:
    tensors = {f"out {k}": v for k, v in out.items()}
    tensors.update({f"param {n}": p.detach() for n, p in
                    state.model.named_parameters()})
    tensors.update({f"buffer {n}": b for n, b in
                    state.model.named_buffers()})
    tensors.update({f"momentum {i}": b for i, b in
                    enumerate(state.momentum_buffers())})
    tensors["generator"] = state.generator.get_state()
    tensors["step"] = torch.tensor(state.step)
    return tensors


def _rel(got: dict, want: dict) -> dict:
    """{name: |got - want| / max(1, |want|)}."""
    return {n: ((got[n].float() - w.float()).abs().max().item()
                / max(1.0, w.float().abs().max().item()))
            for n, w in want.items()}


def _set_to(dst, src):
    """``dst`` takes ``src``'s weights, statistics, momentum, generator
    state and step, in place."""
    dst.model.load_state_dict(src.model.state_dict())
    for a, b in zip(dst.momentum_buffers(), src.momentum_buffers()):
        a.copy_(b)
    dst.generator.set_state(src.generator.get_state())
    dst.step = src.step


@pytest.mark.cuda
def test_cuda_graphed_epoch_matches_eager():
    """Three epochs of the epoch function (the warm-ups, the captures,
    then replays), each against the same epoch run eagerly, set to the
    graphed state first: each tensor within 1e-5 x max(1, |eager|), the
    generator's state and the step equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs run only there)")
    cudnn = torch.backends.cudnn
    tf32, deterministic = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        train, val = _split(5, N), _split(6, N_VAL)
        mask = torch.as_tensor(_rows(0)[2]).cuda()
        fused, eager = _state(), _state()
        fused.ensure_rates(6)  # every epoch's rates: a grown table binds
        for epoch in range(3):
            idx, tail, _ = _rows(epoch)
            _set_to(eager, fused)
            got = _everything(fused, survival_train_epoch(
                fused, train, idx, tail, mask, val_ds=val, blend=True,
                augment=True, with_val=True))
            diffs = _rel(got, _everything(
                eager, _loop(eager, train, val, idx, tail, mask)))
            for name in ("generator", "step"):
                assert diffs[name] == 0.0, name
            for name, d in diffs.items():
                assert d <= 1e-5, (epoch, name, d)
        bodies = [g for v in fused.graphs.values()
                  for g in (v.graphs.values()
                            if isinstance(v, graphs.EpochSteps) else [v])]
        assert len(bodies) == 3
        assert all(b.graph is not None and b.binds == 1 for b in bodies)
        assert bodies[0].replays == 2  # epochs 2 and 3, one step each
        assert bodies[0].launches_per_capture == A * 4  # 4 dense layers
    finally:
        cudnn.allow_tf32, cudnn.deterministic = tf32, deterministic


@pytest.mark.cuda
def test_cuda_capture_raises_naming_the_op(monkeypatch):
    """A host sync planted in the step body: the capture raises
    GraphCaptureError naming the line; nothing runs eagerly instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs run only there)")
    real = steps.multi_cox_loss

    def synced(*args, **kw):
        loss = real(*args, **kw)
        loss.item()  # planted host sync
        return loss

    monkeypatch.setattr(steps, "multi_cox_loss", synced)
    train, state = _split(5, N), _state()
    state.ensure_rates(4)
    idx = _rows(0)[0]
    survival_train_epoch(state, train, idx, blend=False)  # the warm-up
    with pytest.raises(graphs.GraphCaptureError, match="planted host sync"):
        survival_train_epoch(state, train, idx, blend=False)
    (epoch,) = state.graphs.values()
    assert epoch.graphs["step"].graph is None


@pytest.mark.cuda
def test_cuda_capture_outlives_a_dead_graph(monkeypatch):
    """A finished run's state (a reference cycle that holds its captured
    graphs) made unreachable inside the next state's capture, with the
    collector set to run at every allocation: no collection starts during
    the capture (one could destroy the dead graphs, and a graph destroyed
    during a capture invalidates the capture), the capture succeeds, and
    the dead state goes at the next collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs run only there)")
    train, idx = _split(5, N), _rows(0)[0]
    dead = [_state()]
    dead[0].ensure_rates(4)
    for _ in range(2):  # the warm-up, then the capture
        survival_train_epoch(dead[0], train, idx, blend=False)
    (epoch,) = dead[0].graphs.values()
    assert epoch.graphs["step"].graph is not None
    real = steps.multi_cox_loss

    def drop_the_dead(*args, **kw):
        if torch.cuda.is_current_stream_capturing() and dead:
            dead.clear()  # now only the cycle holds it
            for _ in range(1000):  # allocations that would collect
                cycle = []
                cycle.append(cycle)
        return real(*args, **kw)

    during = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    monkeypatch.setattr(steps, "multi_cox_loss", drop_the_dead)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        state = _state()
        state.ensure_rates(4)
        for _ in range(3):  # the warm-up, the capture, a replay
            survival_train_epoch(state, train, idx, blend=False)
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert not dead and during == []
    (epoch,) = state.graphs.values()
    assert epoch.graphs["step"].graph is not None
    assert epoch.graphs["step"].replays == 2  # epochs 2 and 3, one step each
    assert gc.isenabled()
    gc.collect()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_max_pool_backward_is_deterministic():
    """The stem's max pool (3, 2, 1) on the card at the flagship's shape:
    its backward gives the same bits twice (torch's own adds with atomics)
    and agrees with torch's within float32 roundoff."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((8, 64, 32, 32, 32), device="cuda", generator=gen
                    ).to(memory_format=CHANNELS_LAST)
    g = torch.randn((8, 64, 16, 16, 16), device="cuda", generator=gen
                    ).to(memory_format=CHANNELS_LAST)
    grads = []
    for pool in (max_pool, max_pool, torch.nn.functional.max_pool3d):
        xi = x.clone().requires_grad_()
        pool(xi, 3, 2, 1).backward(g)
        grads.append(xi.grad)
    assert torch.equal(grads[0], grads[1])
    assert grads[0].is_contiguous(memory_format=CHANNELS_LAST)
    assert (grads[0] - grads[2]).abs().max().item() <= 1e-5
