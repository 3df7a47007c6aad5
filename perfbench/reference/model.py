"""Plain PyTorch reference of the survival models the benchmark trains.

Written from the model's published description (MONAI's 3D DenseNet with
the MMNN_STS feature head, the clinical MLP and the gradient-blending
heads) and the semantics the program states for them, with no kernel, no
fused op and no CUDA graph: float32 throughout, TF32 off
(``check.reference_side`` turns it off around the reference).

Semantics followed (where they differ from torch's own layers):

* BatchNorm: batch statistics as ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)``
  over every axis but channels, only over the valid rows of a masked batch
  (a fully masked batch gives mean 0, var 1); output ``(x - mean) *
  rsqrt(var + 1e-5) * weight + bias`` with masked rows zeroed; running
  statistics ``0.9 r + 0.1 batch``, the variance unbiased.
* The DenseNet bottleneck: BatchNorm on the batch statistics, ReLU and a
  1x1x1 convolution, written as a matrix product; its masked rows are not
  zeroed. Its parameters are ``scale``, ``bias``, ``kernel`` (Cin, Cout)
  and running ``mean``, ``var``.
* Dropout draws ``torch.rand`` from the run's generator, one draw a
  layer in forward order (the dense layers' channel dropout as a (B, C,
  1, 1, 1) draw, then the feature head's, then the clinical MLP's six), and
  keeps an element where the draw is below ``1 - p``, scaled by ``1 / (1 -
  p)``.

Parameter names are the checkpoint key scheme of the program (torch names
of the JAX modules), so one weights dict loads into both.

``precision="fp8"`` computes at the configuration's cast points in
float8 e4m3 with a per-tensor scale (amax to 448): both operands and the
output of every convolution and matrix product, and every BatchNorm's
output, each rounded, the arithmetic between them in float32 and the
gradients passed straight through the rounding. It is the control that a
configuration computing in bfloat16 has to tell apart from itself.
``precision="bfloat16"`` rounds at the same points to bfloat16: a witness
of how far bfloat16 alone moves the reference (``calibrate.py``'s look).
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


def _channels(v, x):
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
        y = (x - _channels(mean, x)) * _channels(
            torch.rsqrt(var + BN_EPS) * self.weight, x) + _channels(
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


class Bottleneck(nn.Module):
    """BatchNorm (batch statistics in train mode) + ReLU + 1x1x1 conv."""

    def __init__(self, c_in: int, c_out: int, precision: str):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c_in))
        self.bias = nn.Parameter(torch.zeros(c_in))
        self.kernel = nn.Parameter(torch.zeros(c_in, c_out))
        self.register_buffer("mean", torch.zeros(c_in))
        self.register_buffer("var", torch.ones(c_in))
        self.precision = precision

    def forward(self, x, mask=None):
        if self.training:
            mean, var, unbiased, valid = batch_stats(x, mask)
            fold_running(self.mean, self.var, mean.detach(),
                         unbiased.detach(), valid)
        else:
            mean, var = self.mean, self.var
        h = F.relu((x - _channels(mean, x)) * _channels(
            torch.rsqrt(var + BN_EPS) * self.scale, x)
            + _channels(self.bias, x))
        p = self.precision
        rows = h.movedim(1, -1)
        out = operand(operand(rows, p) @ operand(self.kernel, p), p)
        return out.movedim(-1, 1)


class DenseLayer(nn.Module):
    def __init__(self, c_in, growth, bn_size, p_drop, precision):
        super().__init__()
        self.fused1 = Bottleneck(c_in, bn_size * growth, precision)
        self.norm2 = BatchNorm(bn_size * growth, precision)
        self.conv2 = Conv3d(bn_size * growth, growth, 3, 1, 1, precision)
        self.p_drop = p_drop

    def forward(self, x, mask, generator):
        y = self.conv2(F.relu(self.norm2(self.fused1(x, mask), mask)))
        if self.training:
            y = dropout(y, self.p_drop, generator, channels=True)
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, c_in, c_out, precision):
        super().__init__()
        self.norm = BatchNorm(c_in, precision)
        self.conv = Conv3d(c_in, c_out, 1, 1, 0, precision)

    def forward(self, x, mask):
        return F.avg_pool3d(self.conv(F.relu(self.norm(x, mask))), 2, 2)


class DenseNet3D(nn.Module):
    """3D DenseNet of a block configuration (MONAI ``DenseNet``): stem
    conv 7^3 stride 2 + BN + ReLU + max pool 3 stride 2, dense blocks with
    transitions halving channels and side, a final BN; then the feature
    head (ReLU, global average pool, Linear to ``feature_channels``,
    dropout) or, with ``feature_channels=None``, ReLU and the pool alone;
    and the ``out`` Linear where ``out_channels`` is given."""

    def __init__(self, block_config, in_channels=2, init_features=64,
                 growth_rate=32, bn_size=4, dropout_prob=0.0,
                 feature_channels=12, out_channels=None,
                 precision="float32"):
        super().__init__()
        self.block_config = tuple(block_config)
        self.p_drop = dropout_prob
        self.conv0 = Conv3d(in_channels, init_features, 7, 2, 3, precision)
        self.norm0 = BatchNorm(init_features, precision)
        ch = init_features
        for i, n in enumerate(self.block_config):
            for j in range(n):
                self.add_module(f"block{i + 1}_layer{j + 1}", DenseLayer(
                    ch, growth_rate, bn_size, dropout_prob, precision))
                ch += growth_rate
            if i == len(self.block_config) - 1:
                self.norm5 = BatchNorm(ch, precision)
            else:
                self.add_module(f"transition{i + 1}",
                                Transition(ch, ch // 2, precision))
                ch //= 2
        self.vanilla = feature_channels is None
        if not self.vanilla:
            self.feature_layer = Linear(ch, feature_channels, precision)
            ch = feature_channels
        if out_channels is not None:
            self.out = Linear(ch, out_channels, precision)

    def features(self, x, mask=None, generator=None):
        """x (N, D, H, W, C) -> (N, F) features."""
        x = x.movedim(-1, 1)
        x = F.max_pool3d(F.relu(self.norm0(self.conv0(x), mask)), 3, 2, 1)
        for i, n in enumerate(self.block_config):
            for j in range(n):
                x = getattr(self, f"block{i + 1}_layer{j + 1}")(
                    x, mask, generator)
            if i == len(self.block_config) - 1:
                x = self.norm5(x, mask)
            else:
                x = getattr(self, f"transition{i + 1}")(x, mask)
        x = F.relu(x).mean(dim=(2, 3, 4))
        if self.vanilla:
            return x
        x = self.feature_layer(x)
        if self.training:
            x = dropout(x, self.p_drop, generator, channels=False)
        return x

    def forward(self, x, mask=None, generator=None):
        return self.out(self.features(x, mask, generator))


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
    (multimodal, image, clinical)."""

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
        img = self.image_model.features(inputs["image"], mask, generator)
        clin = self.clinical_model(inputs["clinical"], mask, generator)
        return torch.stack([
            self.output_head(torch.cat([img, clin], dim=1)),
            self.image_output_head(img),
            self.clinical_output_head(clin)])


def build(model_cfg: dict, precision: str = "float32") -> nn.Module:
    """The reference model of a configuration file's ``model`` section."""
    d = model_cfg
    kind = d["kind"]
    common = dict(block_config=d["block_config"],
                  in_channels=d["in_channels"],
                  init_features=d["init_features"],
                  growth_rate=d["growth_rate"], bn_size=d["bn_size"],
                  dropout_prob=d["image_dropout"], precision=precision)
    if kind == "densenet_blend":
        image = DenseNet3D(feature_channels=d["feature_layers"],
                           out_channels=None, **common)
        return BlendModel(image, d["clinical_inputs"], d["feature_layers"],
                          d["classes"], d["clinical_dropout"], precision)
    if kind == "densenet":
        return DenseNet3D(feature_channels=None, out_channels=d["classes"],
                          **common)
    raise ValueError(f"unknown reference model kind {kind!r}")


def init_kind(name: str, shape) -> tuple[str, int]:
    """How the benchmark's weights initialise a tensor of this name:
    ("ones" | "zeros" | "kaiming" | "lecun", fan_in)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_var", "var") or (leaf in ("weight", "scale")
                                          and len(shape) == 1):
        return "ones", 0
    if leaf in ("bias", "running_mean", "mean"):
        return "zeros", 0
    if leaf == "kernel":  # the bottleneck's (Cin, Cout)
        return "kaiming", shape[0]
    if len(shape) == 5:
        return "kaiming", math.prod(shape[1:])
    if len(shape) == 2:
        return "lecun", shape[1]
    raise ValueError(f"no initialisation for {name} {tuple(shape)}")


def weight_spec(model_cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter and buffer, in module order."""
    with torch.device("meta"):
        model = build(model_cfg)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
