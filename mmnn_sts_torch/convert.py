"""Weight bridge between the JAX package's flat ``.npz`` checkpoints and the
port's ``state_dict``.

The JAX package saves parameters flat, one array per key
(``train/checkpoint.save_params_npz``): ``params/<module path>/<leaf>`` and
``batch_stats/<module path>/<leaf>``. The port's modules carry the JAX
module names, so a key maps to a ``state_dict`` name by its path, with:

* convolution kernels transposed ``(k, k, k, I, O) -> (O, I, k, k, k)``;
* dense kernels transposed ``(I, O) -> (O, I)``;
* BatchNorm ``<m>/BatchNorm_0/{scale, bias}`` + ``{mean, var}`` ->
  ``<m>.{weight, bias, running_mean, running_var}``;
* the DenseNet bottleneck read from either JAX layout into the one fused
  port module ``<layer>.fused1.{scale, bias, kernel, mean, var}``: the
  unfused ``norm1/BatchNorm_0`` + ``conv1/kernel (1, 1, 1, Cin, Cout)``, or
  the fused ``fused1/{scale, bias, kernel (Cin, Cout)}`` + ``{mean, var}``.

``to_jax_flat`` writes either layout back, so both round-trip exactly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
_BN_LEAVES_BACK = {v: k for k, v in _BN_LEAVES.items()}
_FUSED_LEAVES = ("scale", "bias", "kernel", "mean", "var")


def _is_bottleneck(path: list[str], name: str) -> bool:
    """``path`` ends in a dense layer's ``name`` submodule."""
    return len(path) >= 2 and path[-1] == name and path[-2].startswith("block")


def _port_entry(key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    collection, _, rest = key.partition("/")
    if collection not in ("params", "batch_stats") or not rest:
        raise ValueError(f"not a params/ or batch_stats/ key: {key!r}")
    parts = rest.split("/")
    path, leaf = parts[:-1], parts[-1]
    if path and path[-1] == "BatchNorm_0" and leaf in _BN_LEAVES:
        path = path[:-1]
        if _is_bottleneck(path, "norm1"):
            return ".".join(path[:-1] + ["fused1", leaf]), value
        return ".".join(path + [_BN_LEAVES[leaf]]), value
    if path and path[-1] == "fused1" and leaf in _FUSED_LEAVES:
        return ".".join(path + [leaf]), value
    if leaf == "kernel" and _is_bottleneck(path, "conv1"):
        return ".".join(path[:-1] + ["fused1", "kernel"]), \
            value.reshape(value.shape[-2:])
    if leaf == "kernel" and value.ndim == 5:
        return ".".join(path + ["weight"]), value.transpose(4, 3, 0, 1, 2)
    if leaf == "kernel" and value.ndim == 2:
        return ".".join(path + ["weight"]), value.T
    if leaf == "bias" and value.ndim == 1:
        return ".".join(path + ["bias"]), value
    raise ValueError(f"unrecognised JAX parameter key {key!r} "
                     f"with shape {value.shape}")


def from_jax_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX flat keys -> port ``state_dict`` (either bottleneck layout)."""
    out = {}
    for key, value in flat.items():
        name, arr = _port_entry(key, np.asarray(value))
        if name in out:
            raise ValueError(f"two JAX keys map to {name!r} (both bottleneck "
                             "layouts in one checkpoint?)")
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def to_jax_flat(state_dict: Mapping[str, torch.Tensor],
                layout: str = "unfused") -> dict[str, np.ndarray]:
    """Port ``state_dict`` -> JAX flat keys, with the DenseNet bottleneck in
    the ``"unfused"`` (``norm1`` + ``conv1``) or ``"fused"`` (``fused1``)
    layout."""
    if layout not in ("unfused", "fused"):
        raise ValueError(f"layout must be 'unfused' or 'fused', got {layout!r}")
    out = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy()
        parts = name.split(".")
        path, leaf = parts[:-1], parts[-1]
        stats = leaf in ("mean", "var", "running_mean", "running_var")
        col = "batch_stats" if stats else "params"
        if path and path[-1] == "fused1":
            if layout == "fused":
                key = path + [leaf]
            elif leaf == "kernel":
                key = path[:-1] + ["conv1", "kernel"]
                value = value.reshape((1, 1, 1) + value.shape)
            else:
                key = path[:-1] + ["norm1", "BatchNorm_0", leaf]
        elif ".".join(path + ["running_mean"]) in state_dict:  # a BatchNorm
            key = path + ["BatchNorm_0", _BN_LEAVES_BACK[leaf]]
        elif leaf == "weight" and value.ndim == 5:
            key = path + ["kernel"]
            value = value.transpose(2, 3, 4, 1, 0)
        elif leaf == "weight" and value.ndim == 2:
            key = path + ["kernel"]
            value = value.T
        elif leaf == "bias":
            key = path + ["bias"]
        else:
            raise ValueError(f"unrecognised port parameter {name!r}")
        out[col + "/" + "/".join(key)] = np.ascontiguousarray(value)
    return out


def load_jax_npz(model: torch.nn.Module, flat) -> torch.nn.Module:
    """Load a JAX flat checkpoint (an ``.npz`` path or a key -> array
    mapping) into ``model``; every key must match (strict)."""
    if isinstance(flat, (str, bytes)) or hasattr(flat, "__fspath__"):
        with np.load(flat) as data:
            flat = {k: data[k] for k in data.files}
    model.load_state_dict(from_jax_flat(flat), strict=True)
    return model
