"""Checkpoints: the full train state with best and latest, the portable
``.npz`` of the weights, and the BHB-10K backbone import (counterpart of
the JAX package's train/checkpoint.py).

* ``save_params_npz`` / ``load_params_npz``: the weights in the JAX
  package's flat key scheme (``params/...``, ``batch_stats/...``) through
  ``convert.to_jax_flat`` and ``convert.load_jax_npz``, so the JAX package's
  ``load_params_npz`` and ``infer.export --weights`` read the port's
  ``best_surv_model.npz``.
* ``AsyncNpzSaver``: the loop's best-model writer. ``submit`` clones the
  weights on the device (no wait for the device); a background thread
  copies the newest snapshot to the host on a side stream and writes it,
  coalescing snapshots that arrive meanwhile, and drains at exit.
* ``CheckpointManager``: ``torch.save`` of the model, the optimizer's
  momentum, the blend state, the step and epoch counters and the
  generator's state, one file per saved epoch; it keeps the newest
  ``max_to_keep`` and the best by ``selection_metric``, and ``restore``
  brings back the newest, so a resumed run carries on exactly.
* ``import_bhb10k_backbone``: a MONAI-layout DenseNet ``.pth`` (the
  BHB-10K contrastive-pretrained backbone) onto the port's module names,
  shape-checked, non-strict (checkpoint.py:273-368).
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time

import numpy as np
import torch

from ..convert import _port_entry, load_jax_npz, to_jax_flat
from ..ops.blending import BlendState
from ..utils.logging import get_logger


def save_params_npz(path: str, model: torch.nn.Module,
                    layout: str = "unfused"):
    """The model's weights as a flat ``.npz`` in the JAX key scheme, with
    the DenseNet bottleneck in ``layout`` (``"unfused"``, the JAX
    package's default model, or ``"fused"``)."""
    np.savez(path, **to_jax_flat(model.state_dict(), layout))


def load_params_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flat ``.npz`` (either bottleneck layout) into ``model``,
    every key matching (strict)."""
    return load_jax_npz(model, path)


class AsyncNpzSaver:
    """Background, coalescing best-model ``.npz`` writer (the JAX
    package's, checkpoint.py:129-240).

    ``submit`` snapshots the weights with a device-side clone and returns:
    the training stream is not fenced by the device-to-host copy. The
    writer thread waits for the clone on a side stream, copies it to the
    host and writes the file. Writes coalesce per path: a newer snapshot
    replaces one not yet written. ``wait`` drains and re-raises the first
    writer error; an ``atexit`` drain keeps a logged best model on disk if
    the run dies later."""

    def __init__(self, layout: str = "unfused"):
        self.layout = layout
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: dict[str, tuple] = {}
        self._busy = 0
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="mmnn-npz-saver", daemon=True)
        self._thread.start()
        atexit.register(self._drain_at_exit)

    def submit(self, path: str, model: torch.nn.Module):
        snap = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ready = None
        device = next(iter(snap.values())).device
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncNpzSaver is closed")
            self._pending[os.path.abspath(path)] = (snap, ready)
            self._wake.notify_all()

    def _write(self, path: str, snap: dict, ready):
        if ready is not None:
            device = next(iter(snap.values())).device
            side = torch.cuda.Stream(device)
            with torch.cuda.stream(side):
                side.wait_event(ready)
                snap = {k: v.to("cpu") for k, v in snap.items()}
        np.savez(path, **to_jax_flat(snap, self.layout))

    def _run(self):
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if not self._pending and self._closed:
                    return
                path, (snap, ready) = next(iter(self._pending.items()))
                del self._pending[path]
                self._busy += 1
            try:
                self._write(path, snap, ready)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                get_logger().error(f"best-model npz write failed: {e!r}")
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._lock:
                    self._busy -= 1
                    self._wake.notify_all()

    def wait(self, timeout: float | None = None):
        """Block until every submitted snapshot is on disk; re-raise the
        first writer error. With ``timeout``, give up after that many
        seconds (work may still be pending)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._pending or self._busy:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                self._wake.wait(remaining)
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _drain_at_exit(self):
        try:
            self.wait(timeout=120.0)
        except Exception:  # noqa: BLE001 — already logged by the writer
            pass

    def close(self):
        self.wait()
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout=60)
        atexit.unregister(self._drain_at_exit)


def _state_blob(state) -> dict:
    b = state.blend
    return {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "blend": {"weights": b.weights, "lvn": b.lvn, "ltn": b.ltn,
                  "has_history": b.has_history},
        "step": state.step,
        "epoch": state.epoch,
        "generator": state.generator.get_state(),
    }


def _load_state_blob(state, blob: dict):
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    device = state.blend.weights.device
    b = blob["blend"]
    state.blend = BlendState(weights=b["weights"].to(device),
                             lvn=b["lvn"].to(device), ltn=b["ltn"].to(device),
                             has_history=bool(b["has_history"]))
    state.step, state.epoch = int(blob["step"]), int(blob["epoch"])
    state.generator.set_state(blob["generator"])
    return state


class CheckpointManager:
    """Full-train-state checkpoints in ``directory``: ``ckpt_<step>.pt``
    files and an ``index.json`` of their metrics. Keeps the newest
    ``max_to_keep`` and the best by ``metrics["selection_metric"]``
    (higher is better)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pt")

    def _index(self) -> dict[int, dict]:
        try:
            with open(os.path.join(self.directory, "index.json")) as f:
                return {int(k): v for k, v in json.load(f).items()}
        except FileNotFoundError:
            return {}

    def _write_index(self, index: dict):
        tmp = os.path.join(self.directory, "index.json.tmp")
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(index.items())}, f)
        os.replace(tmp, os.path.join(self.directory, "index.json"))

    def save(self, step: int, state, metrics: dict | None = None):
        tmp = self._path(step) + ".tmp"
        torch.save(_state_blob(state), tmp)
        os.replace(tmp, self._path(step))
        index = self._index()
        index[int(step)] = dict(metrics or {})
        keep = set(sorted(index)[-self.max_to_keep:])
        keep.add(self.best_step(index))
        for s in [s for s in index if s not in keep]:
            if os.path.exists(self._path(s)):
                os.remove(self._path(s))
            del index[s]
        self._write_index(index)

    def best_step(self, index: dict | None = None):
        index = self._index() if index is None else index
        if not index:
            return None
        return max(index, key=lambda s: (index[s].get("selection_metric",
                                                      0.0), s))

    def latest_step(self):
        index = self._index()
        return max(index) if index else None

    def metrics(self, step: int) -> dict:
        return self._index().get(int(step), {})

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (default: the newest) into ``state`` in
        place and return it, or None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        return _load_state_blob(state, blob)


# ---------------------------------------------------------------------------
# Torch .pth (BHB-10K pretrained DenseNet backbone) import
# ---------------------------------------------------------------------------

_DENSE_KEY = re.compile(
    r"features\.denseblock(\d+)\.denselayer(\d+)\.(norm|conv)([12])\.(.+)"
)
_TRANS_KEY = re.compile(r"features\.transition(\d+)\.(norm|conv)\.(.+)")
_BN_SOURCES = (("scale", "weight", "params"), ("bias", "bias", "params"),
               ("mean", "running_mean", "batch_stats"),
               ("var", "running_var", "batch_stats"))


def import_bhb10k_backbone(pth_path: str, model: torch.nn.Module) -> int:
    """Copy a MONAI-layout DenseNet checkpoint (``features.conv0.weight``,
    ``features.denseblockB.denselayerL.{norm,conv}{1,2}.*``,
    ``features.transitionT.{norm,conv}.*``, ``features.norm5.*``, after a
    ``module.`` strip) into the port's DenseNet ``model`` wherever the
    name and shape match; the rest is left as it is (non-strict). Returns
    the number of convolutions and BatchNorms loaded, counted as the JAX
    package counts them."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    target = model.state_dict()

    def put(jax_key, value) -> bool:
        name, arr = _port_entry(jax_key, value)
        if name not in target or tuple(target[name].shape) != arr.shape:
            return False
        with torch.no_grad():
            target[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        return True

    def put_conv(scope, torch_w) -> int:
        w = np.asarray(torch_w, dtype=np.float32)
        w = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))  # OIk -> kIO
        return int(put("params/" + "/".join(scope) + "/kernel", w))

    def put_bn(scope, prefix) -> int:
        ok = 0
        for leaf, torch_name, col in _BN_SOURCES:
            src = sd.get(prefix + "." + torch_name)
            if src is not None and put(f"{col}/{'/'.join(scope)}/BatchNorm_0/"
                                       f"{leaf}", np.asarray(src, np.float32)):
                ok = 1
        return ok

    loaded = 0
    for key, value in sd.items():
        if key == "features.conv0.weight":
            loaded += put_conv(("conv0",), value)
        elif key in ("features.norm0.weight", "features.norm5.weight"):
            name = key.split(".")[1]
            loaded += put_bn((name,), f"features.{name}")
        elif m := _DENSE_KEY.match(key):
            b, l, kind, idx, leaf = m.groups()
            scope = f"block{b}_layer{l}"
            if kind == "conv" and leaf == "weight":
                loaded += put_conv((scope, f"conv{idx}"), value)
            elif kind == "norm" and leaf == "weight":
                loaded += put_bn((scope, f"norm{idx}"), key.rsplit(".", 1)[0])
        elif t := _TRANS_KEY.match(key):
            tn, kind, leaf = t.groups()
            if kind == "conv" and leaf == "weight":
                loaded += put_conv((f"transition{tn}", "conv"), value)
            elif kind == "norm" and leaf == "weight":
                loaded += put_bn((f"transition{tn}", "norm"),
                                 key.rsplit(".", 1)[0])
    return loaded
