"""Device-resident dataset + batch assembly (counterpart of the JAX
package's data/loader.py:51-228).

The whole split (volumes, clinical rows, targets) is moved to the device
once; a training superstep receives an ``index_select`` of it. Under a
mesh of ranks every rank holds every sample; where the mesh shards volume
depth over its ``space`` axis (``parallel/mesh.input_planes``: only where
the axis divides the depth, as the JAX loader's ``_space_ok``,
loader.py:39-47) a rank holds only its slab of planes of each volume, so
the split's device memory divides by the axis's size.

Batch layout for gradient accumulation: (accum_steps, micro_batch, ...).
The ragged last super-batch of an epoch is wrap-padded from the epoch's
shuffled order; ``EpochBatcher.pad_mask`` flags the pad and that superstep
runs with masked losses, gradients and BatchNorm statistics
(train/steps.py). ``EpochBatcher`` is a copy of the JAX package's, so both
packages shuffle an epoch identically (``default_rng((seed, epoch))``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class DeviceDataset:
    """One split's tensors, on one device."""

    uids: np.ndarray  # host (N,)
    inputs: dict  # {'image': (N, D, H, W, C)?, 'clinical': (N, F)?}
    labels: torch.Tensor | None = None  # (N, C) binary targets
    events: torch.Tensor | None = None  # (N, C)
    durations: torch.Tensor | None = None  # (N, C)

    @property
    def num_samples(self) -> int:
        return len(self.uids)

    @property
    def multimodal(self) -> bool:
        return len(self.inputs) > 1

    @property
    def device(self) -> torch.device:
        return next(iter(self.inputs.values())).device

    def model_inputs(self, idx=None):
        """What the model takes: a dict for multimodal, the bare tensor
        otherwise; ``idx`` selects samples (a slice or an index)."""
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        if self.multimodal:
            return {k: sel(v) for k, v in self.inputs.items()}
        (only,) = self.inputs.values()
        return sel(only)


def build_device_dataset(
    uids,
    device,
    image_volumes=None,
    clinical=None,
    labels=None,
    events=None,
    durations=None,
    planes: tuple[int, int] | None = None,
) -> DeviceDataset:
    """Place a split's arrays on ``device`` as float32 tensors; of the
    volumes (N, D, H, W, C) only the depth planes ``[start, stop)`` where
    ``planes`` is given."""

    def put(x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)

    inputs = {}
    if image_volumes is not None:
        inputs["image"] = put(depth_slab(image_volumes, planes))
    if clinical is not None:
        inputs["clinical"] = put(clinical)
    if not inputs:
        raise ValueError("dataset needs at least one modality")
    return DeviceDataset(
        uids=np.asarray(uids),
        inputs=inputs,
        labels=put(labels),
        events=put(events),
        durations=put(durations),
    )


def depth_slab(volumes, planes: tuple[int, int] | None):
    """The planes ``[start, stop)`` of volumes (N, D, ...), a copy of their
    own (all of them where ``planes`` is None)."""
    if volumes is None or planes is None:
        return volumes
    return np.ascontiguousarray(volumes[:, planes[0]:planes[1]])


@dataclass
class EpochBatcher:
    """Shuffled index batches with static shapes.

    yields (accum, micro) index arrays for survival supersteps, or (micro,)
    for classification steps. Wrap-pads the tail from the epoch's own
    shuffled order.
    """

    num_samples: int
    micro_batch: int
    accum_steps: int = 1
    seed: int = 42
    # survival supersteps always take (accum, micro) two-level batches,
    # even when accum_steps == 1
    two_level: bool = False
    _epoch: int = field(default=0)

    def steps_per_epoch(self) -> int:
        per_step = self.micro_batch * self.accum_steps
        return int(np.ceil(self.num_samples / per_step))

    @property
    def ragged(self) -> bool:
        """True when the last step is wrap-padded (N not a multiple of the
        step size) and must run with masked semantics (train/steps.py)."""
        per_step = self.micro_batch * self.accum_steps
        return self.num_samples % per_step != 0

    def pad_mask(self) -> np.ndarray:
        """0/1 validity per epoch position, shaped like epoch_indices().

        The pad is always appended after the N real positions (epoch_indices
        concatenates the shuffled order, then the wrap-pad), so the mask is
        epoch-independent: 1 for the first N flattened positions, 0 after.
        Only the LAST step can contain zeros.
        """
        per_step = self.micro_batch * self.accum_steps
        total = self.steps_per_epoch() * per_step
        m = (np.arange(total) < self.num_samples).astype(np.float32)
        if self.accum_steps > 1 or self.two_level:
            return m.reshape(-1, self.accum_steps, self.micro_batch)
        return m.reshape(-1, self.micro_batch)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.num_samples)
        per_step = self.micro_batch * self.accum_steps
        total = self.steps_per_epoch() * per_step
        if total > len(order):
            pad = order[: total - len(order)]
            if len(pad) < total - len(order):  # dataset smaller than one step
                reps = int(np.ceil((total - len(order)) / len(order)))
                pad = np.tile(order, reps)[: total - len(order)]
            order = np.concatenate([order, pad])
        if self.accum_steps > 1 or self.two_level:
            return order.reshape(-1, self.accum_steps, self.micro_batch)
        return order.reshape(-1, self.micro_batch)


def gather_superbatch(ds: DeviceDataset, idx: np.ndarray) -> dict:
    """One (A, B, ...) super-batch (or (B, ...) batch) gathered from the
    split by ``index_select``: {"inputs", and "labels", "events",
    "durations" where present}, on ``ds.device`` (a host-resident split,
    ``data/streaming.HostDataset``, is gathered on the host and copied)."""
    shape = tuple(idx.shape)
    held = next(iter(ds.inputs.values())).device
    flat = torch.as_tensor(np.asarray(idx, dtype=np.int64).reshape(-1)).to(
        held)

    def take(x):
        return x.index_select(0, flat).view(
            shape + tuple(x.shape[1:])).to(ds.device)

    inputs = ds.model_inputs()
    out = {"inputs": ({k: take(v) for k, v in inputs.items()}
                      if isinstance(inputs, dict) else take(inputs))}
    for name in ("labels", "events", "durations"):
        v = getattr(ds, name)
        if v is not None:
            out[name] = take(v)
    return out
