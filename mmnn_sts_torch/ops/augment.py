"""Image preprocessing and training augmentation (counterpart of the JAX
package's ops/augment.py).

Eval half (augment.py:60-70, 413-418): ``eval_transform_batch``, the
JAX package's ``vmap(eval_transform)``: normalise and min-max scale each
volume, its max and min over the whole volume, channels included.

Training half (augment.py:123-410): the same twelve-op stack as JAX's
``train_augment`` (normalize, scale, rotate 15 rad p .5, axis flip p .5,
zoom 0.9-1.1 p .5, intensity shift p .3, contrast p .3, Gaussian smooth
p .2, Gaussian sharpen p .2, histogram shift p .3, Gaussian noise p .3),
split in two:

* ``draw_augment_params(n, generator, device, shape)`` draws the 20
  quantities JAX's ``train_augment`` draws from its 20 keys
  (augment.py:353-407) for n volumes, from an explicit ``torch.Generator``;
* ``apply_train_augment(vols, params)`` is deterministic: the same
  parameters give the same voxels as JAX's formulation, which is kept as
  math: every resample (the rotation's quarter turn and three shears, the
  zoom and flip, the Gaussian blurs) is a banded (n, n) matrix per sample
  applied by a batched einsum over (B, C, D, H, W), and an op applied with
  probability p is computed for every sample and then selected per sample
  with ``torch.where``, as ``_maybe``'s ``jnp.where`` does.

JAX's random bits and torch's cannot match, so the draws agree with JAX's
in distribution only (augment.py:30-31).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..constants import IMAGE_DATA_MEAN, IMAGE_DATA_STDDEV
from ..parallel import mesh

# Gaussian kernels: sigma <= 1.5 -> radius 6 covers 4 sigma (augment.py:57)
_KERNEL_RADIUS = 6
_HIST_POINTS = 10
# (probability of applying) of each stochastic op, in train_augment's order
APPLY_PROBS = {"rotate": 0.5, "flip": 0.5, "zoom": 0.5, "shift": 0.3,
               "contrast": 0.3, "smooth": 0.2, "sharpen": 0.2,
               "histogram": 0.3, "noise": 0.3}


def eval_transform_batch(vols, mean: float = IMAGE_DATA_MEAN,
                         std: float = IMAGE_DATA_STDDEV):
    """The deterministic validation/inference transform of each volume of a
    batch (B, ...): ``(v - mean * max) / (std * max)``, then min-max to
    [0, 1], with max and min over each volume's whole tensor. An all-zero
    volume divides by zero and gives NaN, as in the JAX package."""
    dims = tuple(range(1, vols.dim()))
    mx = vols.amax(dims, keepdim=True)
    img = (vols - mean * mx) / (std * mx)
    mn, mx = img.amin(dims, keepdim=True), img.amax(dims, keepdim=True)
    return (img - mn) / torch.clamp(mx - mn, min=1e-12)


# ---------------------------------------------------------------------------
# Training augmentation: per-sample ops over (B, C, D, H, W)
# ---------------------------------------------------------------------------

_SAMPLE_DIMS = (1, 2, 3, 4)


def _per_sample(x):
    """(B,) -> (B, 1, 1, 1, 1), to broadcast over (B, C, D, H, W)."""
    return x.view(-1, 1, 1, 1, 1)


def _interp_rows(src, n_in: int):
    """(..., n_out) source coords -> (..., n_out, n_in) linear-interpolation
    matrix (augment.py:123-139): the coordinate is clamped to the edge
    first, then split into floor and fraction; ``hi`` is clamped on its
    own."""
    src = torch.clamp(src, 0.0, n_in - 1.0)
    lo = torch.floor(src)
    frac = src - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, 0, n_in - 1)
    return (F.one_hot(lo, n_in).to(src.dtype) * (1.0 - frac)[..., None]
            + F.one_hot(hi, n_in).to(src.dtype) * frac[..., None])


def _rot90(img, k):
    """Quarter turns of each sample of (B, C, D, H, W) in its (D, H) plane,
    ``k`` (B,) in 0..3, as the four ``rot90_k`` branches (augment.py:157-169);
    each branch is computed for the batch and selected per sample."""
    k = _per_sample(k)
    r1 = torch.flip(img.transpose(2, 3), (2,))
    r2 = torch.flip(img, (2, 3))
    r3 = torch.flip(img.transpose(2, 3), (3,))
    return torch.where(k == 0, img, torch.where(
        k == 1, r1, torch.where(k == 2, r2, r3)))


def spatial_transform(img, theta, flip_axis, zoom):
    """Rotate (plane of the first two spatial axes) -> axis flip -> centre
    zoom of each sample of (B, C, D, H, W) (``_spatial_transform_cf``,
    augment.py:146-212). ``theta`` (B,) radians, ``flip_axis`` (B,) in 0..3
    (3: no flip), ``zoom`` (B,).

    An exact quarter turn ``k = round(theta / (pi/2)) mod 4`` (round half to
    even, floor modulo), then three shears of the residual in [-pi/4, pi/4]
    (R = Sx(tan r/2) Sy(-sin r) Sx(tan r/2)), then the zoom with the flip
    folded into its per-axis matrices."""
    _, _, d, h, w = img.shape
    dev, f32 = img.device, torch.float32
    c0, c1, c2 = (d - 1) / 2.0, (h - 1) / 2.0, (w - 1) / 2.0
    half_pi = torch.full((), math.pi / 2.0, dtype=f32, device=dev)
    k = torch.round(theta / half_pi)
    residual = theta - k * half_pi
    img = _rot90(img, torch.remainder(k.long(), 4))

    t = torch.tan(residual / 2.0)[:, None, None]
    s = torch.sin(residual)[:, None, None]
    i_coord = torch.arange(d, dtype=f32, device=dev)
    j_coord = torch.arange(h, dtype=f32, device=dev)

    def shear_x(v, a):  # out[i, j] = in[i + a (j - c1), j]
        m = _interp_rows(i_coord[None, None, :]
                         + a * (j_coord[None, :, None] - c1), d)
        return torch.einsum("bjix,bcxjw->bcijw", m, v)

    def shear_y(v, b):  # out[i, j] = in[i, j + b (i - c0)]
        m = _interp_rows(j_coord[None, None, :]
                         + b * (i_coord[None, :, None] - c0), h)
        return torch.einsum("bijy,bciyw->bcijw", m, v)

    img = shear_x(shear_y(shear_x(img, t), -s), t)

    def axis_matrix(n, c, axis_id):
        src = ((torch.arange(n, dtype=f32, device=dev)[None, :] - c)
               / zoom[:, None] + c)
        src = torch.where(flip_axis[:, None] == axis_id, (n - 1) - src, src)
        return _interp_rows(src, n)

    img = torch.einsum("bix,bcxjw->bcijw", axis_matrix(d, c0, 0), img)
    img = torch.einsum("bjy,bciyw->bcijw", axis_matrix(h, c1, 1), img)
    return torch.einsum("bkw,bcijw->bcijk", axis_matrix(w, c2, 2), img)


def _toeplitz_blur_matrices(n: int, sigma, radius: int = _KERNEL_RADIUS):
    """(B, n, n) banded matrices of a 1-D normalised Gaussian of each
    sample's ``sigma`` (B,), zero padding (augment.py:260-280)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    kern = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)
    kern = kern / kern.sum(-1, keepdim=True)
    idx = torch.arange(n, device=sigma.device)
    diff = idx[:, None] - idx[None, :] + radius
    on_band = (diff >= 0) & (diff <= 2 * radius)
    band = kern[:, torch.clamp(diff, 0, 2 * radius)]
    return torch.where(on_band, band, torch.zeros((), device=sigma.device))


def gaussian_blur(img, sigmas, radius: int = _KERNEL_RADIUS):
    """Separable 3-D Gaussian blur of each sample of (B, C, D, H, W) with
    its per-axis ``sigmas`` (B, 3), as three banded matmuls
    (``_gaussian_blur_cf``, augment.py:283-295)."""
    _, _, d, h, w = img.shape
    out = torch.einsum("bix,bcxjw->bcijw",
                       _toeplitz_blur_matrices(d, sigmas[:, 0], radius), img)
    out = torch.einsum("bjy,bciyw->bcijw",
                       _toeplitz_blur_matrices(h, sigmas[:, 1], radius), out)
    return torch.einsum("bkw,bcijw->bcijk",
                        _toeplitz_blur_matrices(w, sigmas[:, 2], radius), out)


def adjust_contrast(img, gamma):
    """Per-sample gamma (B,) on the min-max range (augment.py:305-308)."""
    mn = img.amin(_SAMPLE_DIMS, keepdim=True)
    mx = img.amax(_SAMPLE_DIMS, keepdim=True)
    rng = torch.clamp(mx - mn, min=1e-7)
    return ((img - mn) / rng) ** _per_sample(gamma) * rng + mn


def control_points(u):
    """Sorted uniforms (B, P) with the end points fixed at 0 and 1: the
    monotone control points of ``histogram_shift`` (augment.py:314-318)."""
    floating = torch.sort(u, dim=-1).values
    return (floating - floating[:, :1]) / torch.clamp(
        floating[:, -1:] - floating[:, :1], min=1e-7)


def histogram_shift(img, points):
    """Monotone remap of each sample's min-max range through its control
    points (B, P) on the uniform grid, as the hat-basis sum
    ``sum_k points[k] * max(0, 1 - |x (P-1) - k|)`` (augment.py:311-333)."""
    mn = img.amin(_SAMPLE_DIMS, keepdim=True)
    mx = img.amax(_SAMPLE_DIMS, keepdim=True)
    rng = torch.clamp(mx - mn, min=1e-7)
    x = (img - mn) / rng * (points.shape[1] - 1)
    shifted = torch.zeros_like(x)
    for k in range(points.shape[1]):
        shifted = shifted + _per_sample(points[:, k]) * torch.clamp(
            1.0 - torch.abs(x - k), min=0.0)
    return shifted * rng + mn


def draw_augment_params(n: int, generator: torch.Generator, device,
                        shape) -> dict:
    """The random quantities of ``train_augment`` (augment.py:353-407) for
    n volumes of per-sample ``shape`` (D, H, W, C), drawn from
    ``generator`` on ``device``: where an op is not applied its parameter
    is already the identity (theta 0, flip 3, zoom 1), as in JAX; the other
    ops keep their draw beside an ``apply_*`` flag. ``noise`` is the full
    standard-normal field in the body layout (n, C, D, H, W)."""
    d, h, w, c = shape

    def uniform(lo, hi, *size):
        return lo + (hi - lo) * torch.rand((n,) + size, generator=generator,
                                           device=device)

    def bernoulli(p):
        return torch.rand(n, generator=generator, device=device) < p

    p = APPLY_PROBS
    theta = torch.where(bernoulli(p["rotate"]), uniform(-15.0, 15.0), 0.0)
    flip = torch.where(bernoulli(p["flip"]), torch.randint(
        0, 3, (n,), generator=generator, device=device), 3)
    zoom = torch.where(bernoulli(p["zoom"]), uniform(0.9, 1.1), 1.0)
    return {
        "theta": theta, "flip_axis": flip, "zoom": zoom,
        "apply_shift": bernoulli(p["shift"]), "offset": uniform(-0.1, 0.1),
        "apply_contrast": bernoulli(p["contrast"]),
        "gamma": uniform(0.5, 4.5),
        "apply_smooth": bernoulli(p["smooth"]),
        "smooth_sigma": uniform(0.25, 1.5, 3),
        "apply_sharpen": bernoulli(p["sharpen"]),
        "sharpen_sigma": uniform(0.5, 1.0, 3),
        "sharpen_alpha": uniform(10.0, 30.0),
        "apply_histogram": bernoulli(p["histogram"]),
        "hist_points": control_points(uniform(0.0, 1.0, _HIST_POINTS)),
        "noise_std": uniform(0.0, 0.05),
        "noise": torch.randn((n, c, d, h, w), generator=generator,
                             device=device),
        "apply_noise": bernoulli(p["noise"]),
    }


def apply_train_augment(vols, params: dict, mean: float = IMAGE_DATA_MEAN,
                        std: float = IMAGE_DATA_STDDEV):
    """The deterministic body of ``train_augment`` on a batch (B, D, H, W,
    C) with ``params`` from ``draw_augment_params`` (B of each); returns
    (B, D, H, W, C). The body runs channels-leading (B, C, D, H, W), as
    JAX's does."""
    img = eval_transform_batch(vols.permute(0, 4, 1, 2, 3), mean, std)
    img = spatial_transform(img, params["theta"], params["flip_axis"],
                            params["zoom"])

    def maybe(flag, new, old):
        return torch.where(_per_sample(params[flag]), new, old)

    img = maybe("apply_shift", img + _per_sample(params["offset"]), img)
    img = maybe("apply_contrast", adjust_contrast(img, params["gamma"]), img)
    img = maybe("apply_smooth", gaussian_blur(img, params["smooth_sigma"]),
                img)
    b1 = gaussian_blur(img, params["sharpen_sigma"])
    b2 = gaussian_blur(img, torch.full_like(params["sharpen_sigma"], 0.5))
    img = maybe("apply_sharpen",
                b1 + _per_sample(params["sharpen_alpha"]) * (b1 - b2), img)
    img = maybe("apply_histogram", histogram_shift(img, params["hist_points"]),
                img)
    img = maybe("apply_noise",
                img + _per_sample(params["noise_std"]) * params["noise"], img)
    return img.permute(0, 2, 3, 4, 1)


def train_augment_batch(vols, generator: torch.Generator):
    """Draw and apply the training augmentation for a batch (B, D, H, W,
    C), each volume with its own parameters. Where the batch is one rank's
    rows of a microbatch sharded over the ``data`` axis
    (``parallel/mesh.sharded``), the whole microbatch's parameters are
    drawn, as every rank draws them, and this rank's rows applied."""
    shard = mesh.active_shard()
    n = vols.shape[0] * (1 if shard is None else shard.size)
    params = draw_augment_params(n, generator, vols.device,
                                 tuple(vols.shape[1:]))
    if shard is not None:
        params = {k: shard.rows(v) for k, v in params.items()}
    return apply_train_augment(vols, params)
