"""Plain PyTorch reference: what every model family shares.

A configuration's ``model.kind`` names its family, a module of its own at
``perfbench/reference/kinds/<kind>.py`` under the cell's root, found by
file (``perfbench.cells.Cell.family``). A family module provides:

* ``build(model_cfg, precision="float32") -> nn.Module``: the model of a
  configuration file's ``model`` section. Its forward is ``(x, mask=None,
  generator=None)``, ``x`` the image ``(N, *spatial, C)`` or, for a
  configuration with ``flags.preop``, ``{"image", "clinical"}`` (then the
  family wraps its image model in ``BlendModel``). Its parameter and buffer
  names are the program's checkpoint keys, so that one weights dict loads
  into both. It computes in float32 and rounds, through ``operand``, at
  the configuration's cast points (the operands and output of every
  convolution and product, every BatchNorm's output) in ``precision``:
  ``"fp8"`` (float8 e4m3 at a per-tensor scale, the control that a
  configuration computing in bfloat16 has to tell apart from itself) or
  ``"bfloat16"`` (a witness of how far bfloat16 alone moves the
  reference). It normalises with ``BatchNorm`` (or ``batch_stats`` and
  ``fold_running``), and draws its dropout with ``dropout`` from the
  generator, one draw a dropout layer in the program's module order.
* ``layers(model_cfg, spatial) -> list``: each convolution and matrix
  product of the image encoder's forward on one volume, ``{"name",
  "macs", "first"}`` (``first``: its input is the model's, so no input
  gradient), from the sizes alone. ``perfbench.counts`` adds the clinical
  MLP's and the heads' where the configuration's flags build them.
* optionally ``init_kind(name, shape)``, for a tensor that the shared rule
  (``init_kind`` here) does not cover.

No kernel, no fused op and no CUDA graph: float32 throughout, TF32 off
(``check.reference_side`` turns it off around the reference).

Semantics followed (where they differ from torch's own layers):

* BatchNorm: batch statistics as ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)``
  over every axis but channels, only over the valid rows of a masked batch
  (a fully masked batch gives mean 0, var 1); output ``(x - mean) *
  rsqrt(var + 1e-5) * weight + bias`` with masked rows zeroed; running
  statistics ``0.9 r + 0.1 batch``, the variance unbiased.
* Dropout draws ``torch.rand`` from the run's generator and keeps an
  element where the draw is below ``1 - p``, scaled by ``1 / (1 - p)``;
  a channel dropout draws (B, C, 1, 1, 1).
* The multimodal model (``BlendModel``): the image model's features, then
  the clinical MLP's six stages (each drawing its dropout), then a fusion
  head on their concatenation and one head on each.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
E4M3_MAX = 448.0


class _Round(torch.autograd.Function):
    """Rounding, the gradient passed straight through: to bfloat16, or to
    float8 e4m3 at a per-tensor scale."""

    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bfloat16":
            return x.to(torch.bfloat16).to(x.dtype)
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def operand(x, precision: str):
    """``x`` as a product's operand in ``precision``."""
    if precision == "float32":
        return x
    if precision in ("fp8", "bfloat16"):
        return _Round.apply(x, precision)
    raise ValueError(f"unknown reference precision {precision!r}")


def batch_stats(x, mask):
    """(mean, biased var, unbiased var, any_valid) over every dim but 1."""
    dims = (0,) + tuple(range(2, x.dim()))
    if mask is None:
        n = x.numel() // x.shape[1]
        mean = x.mean(dims)
        var = torch.clamp(x.square().mean(dims) - mean.square(), min=0.0)
        return mean, var, var * (n / max(n - 1, 1)), None
    m = mask.float().view((-1,) + (1,) * (x.dim() - 1))
    n = m.sum() * x[0, 0].numel()
    denom = torch.clamp(n, min=1.0)
    mean = (x * m).sum(dims) / denom
    var = torch.clamp((x.square() * m).sum(dims) / denom - mean.square(),
                      min=0.0)
    valid = n > 0
    mean = torch.where(valid, mean, torch.zeros_like(mean))
    var = torch.where(valid, var, torch.ones_like(var))
    return mean, var, var * (n / torch.clamp(n - 1.0, min=1.0)), valid


@torch.no_grad()
def fold_running(r_mean, r_var, mean, unbiased, valid):
    new_mean = BN_MOMENTUM * r_mean + (1 - BN_MOMENTUM) * mean
    new_var = BN_MOMENTUM * r_var + (1 - BN_MOMENTUM) * unbiased
    if valid is not None:
        new_mean = torch.where(valid, new_mean, r_mean)
        new_var = torch.where(valid, new_var, r_var)
    r_mean.copy_(new_mean)
    r_var.copy_(new_var)


def per_channel(v, x):
    """A (C,) vector shaped to broadcast over dim 1 of ``x``."""
    return v.view((1, -1) + (1,) * (x.dim() - 2))


class BatchNorm(nn.Module):
    def __init__(self, c: int, precision: str = "float32"):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, mask=None):
        if self.training:
            mean, var, unbiased, valid = batch_stats(x, mask)
            fold_running(self.running_mean, self.running_var,
                         mean.detach(), unbiased.detach(), valid)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - per_channel(mean, x)) * per_channel(
            torch.rsqrt(var + BN_EPS) * self.weight, x) + per_channel(
            self.bias, x)
        if self.training and mask is not None:
            y = y * mask.float().view((-1,) + (1,) * (x.dim() - 1))
        return operand(y, self.precision)


def dropout(x, p: float, generator, channels: bool):
    if p == 0.0:
        return x
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    u = torch.rand(shape, generator=generator, device=x.device)
    return x * ((u < 1.0 - p).to(x.dtype) / (1.0 - p))


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int, precision: str):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.precision = precision

    def forward(self, x):
        p = self.precision
        return operand(operand(x, p) @ operand(self.weight, p).T + self.bias,
                       p)


class Conv3d(nn.Module):
    """Bias-free 3D convolution."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 padding: int, precision: str):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k, k))
        self.stride, self.padding, self.precision = stride, padding, precision

    def forward(self, x):
        p = self.precision
        return operand(F.conv3d(operand(x, p), operand(self.weight, p), None,
                                self.stride, self.padding), p)


MLP_WIDTHS = (32, 16, 8, 8, 8)


class ClinicalMLP(nn.Module):
    """Six stages of Linear -> BatchNorm -> dropout -> ReLU, widths 32,
    16, 8, 8, 8 and ``feature_channels``."""

    def __init__(self, n_in, feature_channels, dropout_prob, precision):
        super().__init__()
        self.names = [str(i) for i in range(len(MLP_WIDTHS))] + ["features"]
        prev = n_in
        for name, width in zip(self.names,
                               list(MLP_WIDTHS) + [feature_channels]):
            self.add_module(f"dense_{name}", Linear(prev, width, precision))
            self.add_module(f"bn_{name}", BatchNorm(width, precision))
            prev = width
        self.p_drop = dropout_prob

    def forward(self, x, mask=None, generator=None):
        for name in self.names:
            x = getattr(self, f"bn_{name}")(
                getattr(self, f"dense_{name}")(x), mask)
            if self.training:
                x = dropout(x, self.p_drop, generator, channels=False)
            x = F.relu(x)
        return x


class BlendModel(nn.Module):
    """Image features and clinical features, a fusion head on their
    concatenation and one head on each: (3, N, C) in the order
    (multimodal, image, clinical). ``image_model`` is any family's image
    model built without an output head: its forward returns its (N,
    ``feature_channels``) features."""

    def __init__(self, image_model, n_clinical, feature_channels, classes,
                 clinical_dropout, precision):
        super().__init__()
        self.image_model = image_model
        self.clinical_model = ClinicalMLP(n_clinical, feature_channels,
                                          clinical_dropout, precision)
        self.output_head = Linear(2 * feature_channels, classes, precision)
        self.image_output_head = Linear(feature_channels, classes, precision)
        self.clinical_output_head = Linear(feature_channels, classes,
                                           precision)

    def forward(self, inputs, mask=None, generator=None):
        img = self.image_model(inputs["image"], mask, generator)
        clin = self.clinical_model(inputs["clinical"], mask, generator)
        return torch.stack([
            self.output_head(torch.cat([img, clin], dim=1)),
            self.image_output_head(img),
            self.clinical_output_head(clin)])


def init_kind(name: str, shape) -> tuple[str, int]:
    """How the benchmark's weights initialise a tensor of this name, unless
    its family says otherwise: ("ones" | "zeros" | "kaiming" | "lecun",
    fan_in)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_var", "var") or (leaf in ("weight", "scale")
                                          and len(shape) == 1):
        return "ones", 0
    if leaf in ("bias", "running_mean", "mean"):
        return "zeros", 0
    if leaf == "kernel":  # a (Cin, Cout) 1x1x1 convolution as a product
        return "kaiming", shape[0]
    if len(shape) == 5:
        return "kaiming", math.prod(shape[1:])
    if len(shape) == 2:
        return "lecun", shape[1]
    raise ValueError(f"no initialisation for {name} {tuple(shape)}")


def weight_spec(family, model_cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter and buffer of ``family``'s model
    of ``model_cfg``, in module order."""
    with torch.device("meta"):
        model = family.build(model_cfg)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
