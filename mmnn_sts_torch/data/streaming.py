"""Host-resident splits streamed to the card (counterpart of the JAX
package's data/streaming.py:28-103): ``TPU.device_resident_dataset:
false``.

``HostDataset`` keeps one split in host memory (pinned when its device is
a CUDA card, so copies from it run asynchronously), with
``DeviceDataset``'s interface: ``inputs``, ``labels``, ``events`` and
``durations`` are CPU tensors, ``device`` is where its batches go.
Nothing moves the whole split to the card.

``prefetched_epoch`` yields one epoch's batches on the device with a
one-batch lookahead, as the JAX package's ``device_put`` of batch i + 1
before step i: each superstep's batch is gathered on the host into a
pinned staging buffer and copied to the card on a side stream, which
records an event; the step's stream waits on that event before it reads
the batch. A staging buffer is written again only after its copy has run
(a ring of two). On the CPU the batches are plain host gathers.

The gather is ``index_select`` on the same rows as ``gather_superbatch``,
so a streamed epoch trains on the same bits as a resident one. Where a
mesh shards volume depth over its ``space`` axis, the host split keeps
this rank's slab of planes only (``build_host_dataset``'s ``planes``), so
each prefetched batch copies only the slab.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .loader import EpochBatcher, depth_slab


@dataclass
class HostDataset:
    """One split in host memory; mirrors ``DeviceDataset``."""

    uids: np.ndarray  # (N,)
    inputs: dict  # {'image': (N, D, H, W, C)?, 'clinical': (N, F)?}
    labels: torch.Tensor | None = None
    events: torch.Tensor | None = None
    durations: torch.Tensor | None = None
    device: torch.device = torch.device("cpu")  # where batches go

    @property
    def num_samples(self) -> int:
        return len(self.uids)

    @property
    def multimodal(self) -> bool:
        return len(self.inputs) > 1

    def model_inputs(self, idx=None):
        """As ``DeviceDataset.model_inputs``, on the host."""
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        if self.multimodal:
            return {k: sel(v) for k, v in self.inputs.items()}
        (only,) = self.inputs.values()
        return sel(only)


def build_host_dataset(uids, device, image_volumes=None, clinical=None,
                       labels=None, events=None, durations=None,
                       planes: tuple[int, int] | None = None) -> HostDataset:
    """A split's arrays as float32 host tensors, pinned when ``device`` is
    a CUDA card; of the volumes only the depth planes ``planes`` where it
    is given."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(x):
        if x is None:
            return None
        t = torch.as_tensor(np.asarray(x, dtype=np.float32))
        return t.pin_memory() if pin else t

    inputs = {}
    if image_volumes is not None:
        inputs["image"] = put(depth_slab(image_volumes, planes))
    if clinical is not None:
        inputs["clinical"] = put(clinical)
    if not inputs:
        raise ValueError("dataset needs at least one modality")
    return HostDataset(uids=np.asarray(uids), inputs=inputs,
                       labels=put(labels), events=put(events),
                       durations=put(durations), device=device)


def _leaves(ds: HostDataset) -> dict:
    leaves = {f"inputs/{k}": v for k, v in ds.inputs.items()}
    for name in ("labels", "events", "durations"):
        if getattr(ds, name) is not None:
            leaves[name] = getattr(ds, name)
    return leaves


def _batch(ds: HostDataset, leaves: dict) -> dict:
    """{"inputs", and "labels", "events", "durations" where present} from
    the gathered leaves, shaped as ``gather_superbatch``'s."""
    inputs = {k.split("/", 1)[1]: v for k, v in leaves.items()
              if k.startswith("inputs/")}
    out = {"inputs": inputs if ds.multimodal else next(iter(inputs.values()))}
    out.update({k: v for k, v in leaves.items()
                if not k.startswith("inputs/")})
    return out


def to_device(ds, batch: dict) -> dict:
    """A host batch of ``ds`` on its device (a blocking copy): the chunks
    of evaluation and inference."""
    def put(x):
        return x.to(ds.device)

    inputs = batch["inputs"]
    out = {"inputs": ({k: put(v) for k, v in inputs.items()}
                      if isinstance(inputs, dict) else put(inputs))}
    out.update({k: put(v) for k, v in batch.items() if k != "inputs"})
    return out


def prefetched_epoch(ds: HostDataset, batcher: EpochBatcher, epoch: int):
    """Yield the epoch's batches on ``ds.device`` with one-batch lookahead
    (see the module docstring)."""
    leaves = _leaves(ds)
    order = batcher.epoch_indices(epoch)
    if ds.device.type != "cuda":
        for idx in order:
            flat = torch.as_tensor(idx.reshape(-1))
            yield _batch(ds, {k: v.index_select(0, flat).view(
                idx.shape + v.shape[1:]) for k, v in leaves.items()})
        return

    side = torch.cuda.Stream(ds.device)
    lead = order.shape[1:]
    staging = [{k: torch.empty(lead + v.shape[1:], dtype=v.dtype,
                               pin_memory=True) for k, v in leaves.items()}
               for _ in range(2)]
    copied = [None, None]

    def put(i, idx):
        """Gather batch i into staging i % 2 and copy it to the card on
        the side stream; returns the device leaves and the copy's event."""
        slot = i % 2
        if copied[slot] is not None:
            copied[slot].synchronize()
        flat = torch.as_tensor(idx.reshape(-1))
        with torch.cuda.stream(side):
            dev = {}
            for k, v in leaves.items():
                host = staging[slot][k]
                torch.index_select(v, 0, flat, out=host.view(
                    (-1,) + v.shape[1:]))
                dev[k] = host.to(ds.device, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(side)
        return dev, copied[slot]

    def ready(dev, event):
        current = torch.cuda.current_stream(ds.device)
        current.wait_event(event)
        for v in dev.values():
            v.record_stream(current)
        return _batch(ds, dev)

    pending = None
    for i, idx in enumerate(order):
        nxt = put(i, idx)
        if pending is not None:
            yield ready(*pending)
        pending = nxt
    if pending is not None:
        yield ready(*pending)
