"""Serving export: the trained eval forward as one self-contained file
(counterpart of the JAX package's infer/export.py).

The JAX package serializes a StableHLO program with the weights baked in.
Here the servable is ``torch.save`` of a model spec made of plain values
plus the ``state_dict``; it loads with ``torch.load(weights_only=True)``,
so loading runs no pickled code. ``ServingModel`` rebuilds the model from
the spec and runs the same eval forward: ``eval_transform`` per sample on the
image stream (``preprocess``), the model, and head 0 of blend models.

Run:  python -m mmnn_sts_torch.infer.export --weights best_surv_model.npz \
          --images --preop --blend --out model.pt [--config config.yaml]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import Config, ImageModelConfig
from ..models import build_model
from ..models.registry import count_tabular_inputs
from ..ops.augment import eval_transform_batch

BATCH_SIZES = (1, 2, 4, 8, 16, 32)


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, the card. Raises when the card is asked
    for and there is none: nothing moves to the CPU unless asked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def model_spec(cfg: Config, images: bool, preop: bool, postop: bool,
               blend: bool, num_tabular_inputs: int | None = None) -> dict:
    """What ``ServingModel`` needs to rebuild the model, as plain values:
    ``build_model``'s arguments and the image config."""
    if num_tabular_inputs is None:
        num_tabular_inputs = count_tabular_inputs(cfg, images, preop, postop)
    return {
        "image_model": dataclasses.asdict(cfg.image_model),
        "images": bool(images),
        "preop": bool(preop),
        "postop": bool(postop),
        "blend": bool(blend),
        "num_tabular_inputs": int(num_tabular_inputs),
    }


def export_forward(model: torch.nn.Module, spec: dict, path: str) -> None:
    """Write the servable: ``spec`` (from ``model_spec``) + ``model``'s
    weights, on the CPU."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"spec": dict(spec), "state_dict": state}, path)


def load_exported(path: str, device=None) -> tuple[torch.nn.Module, dict]:
    """Rebuild the exported model on ``device`` (default: the card)."""
    device = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    spec = blob["spec"]
    cfg = Config()
    cfg.image_model = ImageModelConfig(**spec["image_model"])
    model = build_model(cfg, spec["images"], spec["preop"], spec["postop"],
                        spec["blend"], spec["num_tabular_inputs"])
    model.load_state_dict(blob["state_dict"], strict=True)
    return model.to(device).eval(), spec


class ServingModel:
    """Canonical-batch serving over an exported model.

    Every request is padded with zero rows up to the smallest size in
    ``batch_sizes`` that holds it (as the JAX ServingModel does, so the two
    see the same batch shapes), and the answer is sliced back. Eval BN is
    per channel with fixed statistics, so pad rows never mix with real rows;
    a zero image row normalises to NaN and is sliced away.
    """

    def __init__(self, path: str, batch_sizes=BATCH_SIZES, device=None):
        self.device = resolve_device(device)
        self.model, self.spec = load_exported(path, self.device)
        self.batch_sizes = tuple(sorted(batch_sizes))
        im = self.spec["image_model"]
        self._image_shape = tuple(im["spatial_size"]) + (im["in_channels"],)

    def _bucket(self, n: int) -> int:
        for s in self.batch_sizes:
            if s >= n:
                return s
        return n  # oversized request: run at its exact size

    def _expected(self) -> dict:
        """Input name -> per-sample shape the model takes."""
        shapes = {}
        if self.spec["images"]:
            shapes["image"] = self._image_shape
        if self.spec["preop"] or self.spec["postop"] or not self.spec["images"]:
            shapes["clinical"] = (self.spec["num_tabular_inputs"],)
        return shapes

    def _check(self, inputs) -> dict:
        """Validate a request against the spec; returns name -> array.
        Raises ValueError on a wrong modality set or shape (the client's
        fault)."""
        expected = self._expected()
        if not isinstance(inputs, dict):
            if len(expected) != 1:
                raise ValueError(f"model takes inputs {sorted(expected)}, "
                                 "got one bare array")
            inputs = {next(iter(expected)): inputs}
        if set(inputs) != set(expected):
            raise ValueError(f"model takes inputs {sorted(expected)}, "
                             f"got {sorted(inputs)}")
        arrays = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
        n = {a.shape[0] if a.ndim else -1 for a in arrays.values()}
        for k, a in arrays.items():
            if a.ndim == 0 or a.shape[1:] != expected[k] or a.shape[0] < 1:
                raise ValueError(f"input {k!r}: expected shape (B,) + "
                                 f"{expected[k]}, got {a.shape}")
        if len(n) != 1:
            raise ValueError(f"inputs disagree on the batch size: {sorted(n)}")
        return arrays

    @torch.inference_mode()
    def __call__(self, inputs) -> np.ndarray:
        arrays = self._check(inputs)
        n = next(iter(arrays.values())).shape[0]
        m = self._bucket(n)
        tensors = {}
        for k, a in arrays.items():
            t = torch.zeros((m,) + a.shape[1:], dtype=torch.float32,
                            device=self.device)
            t[:n] = torch.from_numpy(a).to(self.device)
            tensors[k] = t
        if "image" in tensors:
            tensors["image"] = eval_transform_batch(tensors["image"])
        if set(tensors) == {"image", "clinical"}:
            out = self.model(tensors)
        else:
            out = self.model(next(iter(tensors.values())))
        if self.spec["blend"]:
            out = out[0]
        return out[:n].cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mmnn_sts_torch.infer.export")
    ap.add_argument("--config", default="",
                    help="YAML config (default: the built-in defaults)")
    ap.add_argument("--weights", required=True,
                    help="JAX flat .npz checkpoint (best_surv_model.npz)")
    ap.add_argument("--images", action="store_true")
    ap.add_argument("--preop", action="store_true")
    ap.add_argument("--postop", action="store_true")
    ap.add_argument("--blend", action="store_true")
    ap.add_argument("--out", required=True, help="servable to write")
    ap.add_argument("--device", default="cuda",
                    help="device the written servable is checked on")
    args = ap.parse_args(argv)
    from ..config import parse_config
    from ..convert import load_jax_npz
    from ..utils.logging import get_logger

    cfg = parse_config(args.config) if args.config else Config()
    model = build_model(cfg, args.images, args.preop, args.postop, args.blend)
    load_jax_npz(model, args.weights)
    spec = model_spec(cfg, args.images, args.preop, args.postop, args.blend)
    export_forward(model, spec, args.out)
    load_exported(args.out, args.device)  # the servable loads on the device
    get_logger().info(f"Exported serving artifact to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
