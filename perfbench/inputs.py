"""The benchmark's inputs, made on the device from the run's seed: the
weights of a configuration and a synthetic survival cohort. The same seed
gives the same inputs; both sides (the program and the reference) receive
them as they are made here.

Seeds: ``split_seed(seed)`` gives three independent 32-bit seeds
(weights, cohort, training loop) from the command line's seed, which may
be any whole number of up to 64 bits.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .reference import common

_TRUNCATED_STD = 0.87962566103423978  # std of N(0, 1) cut at +-2


def split_seed(seed: int) -> dict:
    words = np.random.SeedSequence(int(seed)).generate_state(3)
    return dict(zip(("weights", "cohort", "loop"), (int(w) for w in words)))


def make_weights(cell, seed: int, device) -> dict:
    """One tensor a (name, shape) of the weight spec of the cell's model
    family (``reference.common.weight_spec``), initialised as the family's
    ``init_kind`` says, or else the shared rule: BatchNorm scales and
    running variances 1, shifts, biases and running means 0; convolution
    and bottleneck kernels N(0, 2 / fan_in); dense kernels a normal cut at
    two deviations, of variance 1 / fan_in. Drawn in one call."""
    family = cell.family()
    spec = common.weight_spec(family, cell.config["model"])
    init_kind = getattr(family, "init_kind", common.init_kind)
    g = torch.Generator(device=device).manual_seed(seed)
    kinds = [init_kind(name, shape) for name, shape in spec]
    drawn = sum(int(np.prod(shape)) for (_, shape), (kind, _) in
                zip(spec, kinds) if kind in ("kaiming", "lecun"))
    noise = torch.randn(drawn, generator=g, device=device)
    out, at = {}, 0
    for (name, shape), (kind, fan_in) in zip(spec, kinds):
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = int(np.prod(shape))
            z = noise[at:at + n].view(shape)
            at += n
            if kind == "kaiming":
                out[name] = z * (2.0 / fan_in) ** 0.5
            else:
                out[name] = z.clamp(-2.0, 2.0) * (
                    (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD)
    return out


def make_volumes(n: int, spatial, channels: int, g, device,
                 chunk: int = 64):
    """(n, D, H, W, C) MRI-like volumes: a smooth tissue field per channel,
    a brighter ellipsoidal lesion at a random place and size, and a little
    noise; intensities in about [0, 1500], never all zero. Made ``chunk``
    volumes at a time, so that the temporaries stay small."""
    return torch.cat([_volumes(min(chunk, n - s), spatial, channels, g,
                               device) for s in range(0, n, chunk)])


def _volumes(n: int, spatial, channels: int, g, device):
    d, h, w = spatial
    coarse = torch.randn((n, channels, 6, 6, 6), generator=g, device=device)
    field = F.interpolate(coarse, size=(d, h, w), mode="trilinear",
                          align_corners=False)
    grid = [torch.linspace(-1.0, 1.0, s, device=device) for s in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*grid, indexing="ij")
    centre = torch.rand((n, 3), generator=g, device=device) * 1.0 - 0.5
    radius = 0.15 + 0.25 * torch.rand((n, 3), generator=g, device=device)
    r2 = sum(((c - centre[:, i].view(-1, 1, 1, 1)) /
              radius[:, i].view(-1, 1, 1, 1)) ** 2
             for i, c in enumerate((zz, yy, xx)))
    lesion = torch.exp(-2.0 * r2).unsqueeze(1)
    weights = 0.5 + torch.rand((n, channels, 1, 1, 1), generator=g,
                               device=device)
    vols = 400.0 + 150.0 * field + 700.0 * weights * lesion
    vols = vols + 20.0 * torch.randn(vols.shape, generator=g, device=device)
    return vols.clamp(min=1.0).permute(0, 2, 3, 4, 1).contiguous()


def make_split(n: int, traffic: dict, model: dict, spatial, g, device,
               with_clinical: bool):
    """One split: volumes, where ``with_clinical`` the clinical rows
    (standardised predictors, about a third of them binary), events and
    durations of each target."""
    classes = model["classes"]
    split = {"image": make_volumes(n, spatial, model["in_channels"], g,
                                   device)}
    if with_clinical:
        k = model["clinical_inputs"]
        clinical = torch.randn((n, k), generator=g, device=device)
        binary = torch.rand((n, k), generator=g, device=device) < 0.5
        binary_cols = torch.arange(k, device=device) % 3 == 0
        split["clinical"] = torch.where(binary_cols, binary.float() * 2 - 1,
                                        clinical)
    split["events"] = (torch.rand((n, classes), generator=g, device=device)
                       < traffic["event_rate"]).float()
    lo, hi = traffic["duration_months"]
    split["durations"] = torch.randint(lo, hi + 1, (n, classes), generator=g,
                                       device=device).float()
    return split


def make_cohort(cell, seed: int, device) -> dict:
    """{"train": split, "val": split} of the traffic's sizes, with clinical
    rows where the configuration's ``flags.preop`` asks for them."""
    g = torch.Generator(device=device).manual_seed(seed)
    traffic, config = cell.traffic, cell.config
    spatial = tuple(config["ImageModel"]["spatial_size"])
    return {name: make_split(traffic[f"{name}_patients"], traffic,
                             config["model"], spatial, g, device,
                             config["flags"]["preop"])
            for name in ("train", "val")}
