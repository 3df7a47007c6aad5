"""Plain reference of the training augmentation and the eval transform.

The MMNN_STS training transform (MONAI's, as the program's configuration
states it): per volume, normalise ``(v - mean * max) / (std * max)`` and
min-max scale to [0, 1] over the whole volume; then a rotation in the
plane of the first two spatial axes (p 0.5, angle in [-15, 15] rad), a
flip of one axis (p 0.5), a centre zoom in [0.9, 1.1] (p 0.5), an
intensity shift (p 0.3), a contrast gamma in [0.5, 4.5] (p 0.3), a
Gaussian smooth (p 0.2), a Gaussian sharpen (p 0.2), a histogram shift
through 10 control points (p 0.3) and Gaussian noise (p 0.3).

The rotation is an exact quarter turn of ``round(angle / (pi/2))`` and
three shears of the residual angle (``R = Sx(tan r/2) Sy(-sin r) Sx(tan
r/2)``), each a linear interpolation along one axis with coordinates
clamped to the volume; the zoom and flip resample each axis the same way.
Here every resample gathers the two neighbouring voxels and blends them,
and every Gaussian is a 13-tap (radius 6) zero-padded sum along one axis:
the same arithmetic as the program's banded matrices, written without
them.

The random quantities come from the run's ``torch.Generator``, drawn in the
order the configuration's transform lists them, as the program draws
them (``draw``): the two sides then see the same augmentation.
"""

from __future__ import annotations

import math

import torch

IMAGE_MEAN = 286.90859071507913
IMAGE_STD = 581.7816096485366
RADIUS = 6
HIST_POINTS = 10
PROBS = {"rotate": 0.5, "flip": 0.5, "zoom": 0.5, "shift": 0.3,
         "contrast": 0.3, "smooth": 0.2, "sharpen": 0.2, "histogram": 0.3,
         "noise": 0.3}


def eval_transform(vols):
    """Per-volume normalisation and min-max scaling of (B, ...)."""
    dims = tuple(range(1, vols.dim()))
    mx = vols.amax(dims, keepdim=True)
    img = (vols - IMAGE_MEAN * mx) / (IMAGE_STD * mx)
    lo, hi = img.amin(dims, keepdim=True), img.amax(dims, keepdim=True)
    return (img - lo) / torch.clamp(hi - lo, min=1e-12)


def draw(n: int, shape, generator, device) -> dict:
    """The augmentation's random quantities for n volumes of per-volume
    shape (D, H, W, C), in the transform's order."""
    d, h, w, c = shape

    def rand(*size):
        return torch.rand((n,) + size, generator=generator, device=device)

    def uniform(lo, hi, *size):
        return lo + (hi - lo) * rand(*size)

    out = {}
    out["theta"] = torch.where(rand() < PROBS["rotate"],
                               uniform(-15.0, 15.0), 0.0)
    flip_on = rand() < PROBS["flip"]
    out["flip_axis"] = torch.where(flip_on, torch.randint(
        0, 3, (n,), generator=generator, device=device), 3)
    zoom_on = rand() < PROBS["zoom"]
    out["zoom"] = torch.where(zoom_on, uniform(0.9, 1.1), 1.0)
    out["apply_shift"] = rand() < PROBS["shift"]
    out["offset"] = uniform(-0.1, 0.1)
    out["apply_contrast"] = rand() < PROBS["contrast"]
    out["gamma"] = uniform(0.5, 4.5)
    out["apply_smooth"] = rand() < PROBS["smooth"]
    out["smooth_sigma"] = uniform(0.25, 1.5, 3)
    out["apply_sharpen"] = rand() < PROBS["sharpen"]
    out["sharpen_sigma"] = uniform(0.5, 1.0, 3)
    out["sharpen_alpha"] = uniform(10.0, 30.0)
    out["apply_histogram"] = rand() < PROBS["histogram"]
    points = torch.sort(uniform(0.0, 1.0, HIST_POINTS), dim=-1).values
    out["hist_points"] = (points - points[:, :1]) / torch.clamp(
        points[:, -1:] - points[:, :1], min=1e-7)
    out["noise_std"] = uniform(0.0, 0.05)
    out["noise"] = torch.randn((n, c, d, h, w), generator=generator,
                               device=device)
    out["apply_noise"] = rand() < PROBS["noise"]
    return out


def _per(x):
    return x.view(-1, 1, 1, 1, 1)


def resample(img, axis: int, src):
    """Linear interpolation of (B, C, D, H, W) along ``axis`` (2, 3 or 4)
    at source coordinates ``src``, broadcastable to (B, 1, D, H, W) and
    giving for each output voxel its coordinate on ``axis``; coordinates
    are clamped to the axis first."""
    n = img.shape[axis]
    src = torch.clamp(src, 0.0, n - 1.0)
    lo = torch.floor(src)
    frac = src - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    shape = img.shape
    lo = lo.expand(shape[0], 1, *shape[2:]).expand(shape)
    hi = hi.expand(shape[0], 1, *shape[2:]).expand(shape)
    return (torch.gather(img, axis, lo) * (1.0 - frac)
            + torch.gather(img, axis, hi) * frac)


def _coord(n, axis, device):
    """0..n-1 along ``axis`` of a (1, 1, D, H, W)-broadcastable tensor."""
    shape = [1, 1, 1, 1, 1]
    shape[axis] = n
    return torch.arange(n, dtype=torch.float32, device=device).view(shape)


def quarter_turn(img, k):
    """Rotate each volume by k[b] quarter turns in its (D, H) plane."""
    t = img.transpose(2, 3)
    turns = [img, torch.flip(t, (2,)), torch.flip(img, (2, 3)),
             torch.flip(t, (3,))]
    out = turns[3]
    for q in (2, 1, 0):
        out = torch.where(_per(k) == q, turns[q], out)
    return out


def spatial(img, theta, flip_axis, zoom):
    _, _, d, h, w = img.shape
    dev = img.device
    c = [(n - 1) / 2.0 for n in (d, h, w)]
    half_pi = torch.tensor(math.pi / 2.0, dtype=torch.float32, device=dev)
    k = torch.round(theta / half_pi)
    r = theta - k * half_pi
    img = quarter_turn(img, torch.remainder(k.long(), 4))
    tan_half, sin = _per(torch.tan(r / 2.0)), _per(torch.sin(r))
    i, j = _coord(d, 2, dev), _coord(h, 3, dev)
    # shear along D by a (j - c_h), along H by b (i - c_d)
    img = resample(img, 2, i + tan_half * (j - c[1]))
    img = resample(img, 3, j - sin * (i - c[0]))
    img = resample(img, 2, i + tan_half * (j - c[1]))
    for axis, n, centre in ((2, d, c[0]), (3, h, c[1]), (4, w, c[2])):
        src = (_coord(n, axis, dev) - centre) / _per(zoom) + centre
        src = torch.where(_per(flip_axis) == axis - 2, (n - 1) - src, src)
        img = resample(img, axis, src)
    return img


def blur(img, sigmas):
    """Separable zero-padded Gaussian of each volume, sigmas (B, 3)."""
    taps = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32,
                        device=img.device)
    for a, axis in enumerate((2, 3, 4)):
        kern = torch.exp(-0.5 * (taps[None, :] / sigmas[:, a, None]) ** 2)
        kern = kern / kern.sum(-1, keepdim=True)
        n = img.shape[axis]
        pad = [0] * 6
        pad[2 * (4 - axis)] = pad[2 * (4 - axis) + 1] = RADIUS
        padded = torch.nn.functional.pad(img, pad)
        out = torch.zeros_like(img)
        for t in range(2 * RADIUS + 1):
            # out[i] += kern[t] * in[i + RADIUS - t]
            out = out + _per(kern[:, t]) * padded.narrow(
                axis, 2 * RADIUS - t, n)
        img = out
    return img


def _range(img):
    dims = (1, 2, 3, 4)
    lo, hi = img.amin(dims, keepdim=True), img.amax(dims, keepdim=True)
    return lo, torch.clamp(hi - lo, min=1e-7)


def augment(vols, p: dict):
    """Apply drawn parameters ``p`` to (B, D, H, W, C) volumes."""
    img = eval_transform(vols.permute(0, 4, 1, 2, 3))
    img = spatial(img, p["theta"], p["flip_axis"], p["zoom"])

    def maybe(flag, new, old):
        return torch.where(_per(p[flag]), new, old)

    img = maybe("apply_shift", img + _per(p["offset"]), img)
    lo, rng = _range(img)
    img = maybe("apply_contrast",
                ((img - lo) / rng) ** _per(p["gamma"]) * rng + lo, img)
    img = maybe("apply_smooth", blur(img, p["smooth_sigma"]), img)
    b1 = blur(img, p["sharpen_sigma"])
    b2 = blur(img, torch.full_like(p["sharpen_sigma"], 0.5))
    img = maybe("apply_sharpen", b1 + _per(p["sharpen_alpha"]) * (b1 - b2),
                img)
    lo, rng = _range(img)
    x = (img - lo) / rng * (HIST_POINTS - 1)
    pts = p["hist_points"]
    shifted = sum(_per(pts[:, q]) * torch.clamp(1.0 - torch.abs(x - q),
                                                min=0.0)
                  for q in range(HIST_POINTS))
    img = maybe("apply_histogram", shifted * rng + lo, img)
    img = maybe("apply_noise", img + _per(p["noise_std"]) * p["noise"], img)
    return img.permute(0, 2, 3, 4, 1)
