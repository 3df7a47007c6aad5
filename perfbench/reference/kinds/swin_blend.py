"""Reference family ``swin_blend``: Swin UNETR's 3D Swin-transformer encoder
(Hatamizadeh et al. 2022, arXiv:2201.01266; MONAI ``SwinTransformer``, the
``swinViT`` of ``SwinUNETR``) with the feature head (a LayerNorm without
affine, the mean over tokens, Linear to ``feature_layers``, dropout) as the
image model of the shared ``BlendModel``. Written from the published
description; the shared pieces and the family contract are in
``perfbench.reference.common``.

The configuration's ``model`` section gives ``feature_size``, ``depths``,
``num_heads``, ``window_size``, ``patch_size`` and ``mlp_ratio``.
Tokens are (N, D, H, W, C), float32 throughout.

* Patch embedding: a 3D convolution of kernel and stride ``patch_size``,
  with a bias.
* Four stages (``layers1`` .. ``layers4``): Swin blocks, then patch
  merging (the eight offsets of each 2x2x2 cell, d, h, w in
  lexicographic order, concatenated; LayerNorm; a bias-free Linear
  to twice the channels).
* A block: ``x + attention(norm1(x))``, then ``x + linear2(gelu(linear1(
  norm2(x))))`` (exact GELU, hidden ``mlp_ratio`` times the channels).
* The attention: the normed grid padded with zeros to whole windows; on
  odd blocks rolled back by half a window on each axis; a window per axis
  of ``min(window_size, grid)`` (and no shift where the grid is no larger
  than the window); per window ``softmax(q kᵀ / sqrt(d) + B + M) v``, q, k
  and v from one Linear with a bias, heads of ``C / heads`` channels, then
  the output Linear; rolled forward again and cropped. ``B`` is the table
  ``relative_position_bias_table`` ((2w - 1)³, heads) read at each pair's
  relative offset in the full window, the first n rows and columns of it
  where a window holds n < w³ tokens (MONAI's, not the n-token window's
  own offsets). ``M`` is -100 between two tokens that the roll brought
  from different regions of the padded grid, else 0. Padded tokens take
  part as keys. The attention is computed a few windows at a time.
* No dropout inside the encoder (every rate 0); the feature head's
  dropout draws once, before the clinical MLP's six.

Cast points (``operand``): the operands and output of every Linear and of
the patch convolution, of the two attention products, and every
LayerNorm's output.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference import common
from perfbench.reference.common import BlendModel, Linear, dropout, operand

LN_EPS = 1e-5
MASKED = -100.0
# scores of at most this many elements are computed at once
CHUNK = 1 << 27
# std of the encoder's Linears and bias table (MONAI's trunc_normal_): the
# shared rule's cut normal at this fan-in has a scale of 0.02
INIT_FAN = 1.0 / (0.02 * 0.87962566103423978) ** 2


class LayerNorm(nn.Module):
    def __init__(self, c: int, precision: str, affine: bool = True):
        super().__init__()
        self.precision = precision
        self.c = c
        if affine:
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LN_EPS)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return operand(y, self.precision)


class Projection(nn.Module):
    """A bias-free Linear."""

    def __init__(self, n_in: int, n_out: int, precision: str):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.precision = precision

    def forward(self, x):
        p = self.precision
        return operand(operand(x, p) @ operand(self.weight, p).T, p)


class PatchEmbed(nn.Module):
    def __init__(self, c_in: int, c_out: int, patch: int, precision: str):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, patch, patch,
                                               patch))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.patch, self.precision = patch, precision

    def forward(self, x):
        """(N, D, H, W, C) -> (N, D/p, H/p, W/p, C')."""
        p = self.precision
        y = F.conv3d(operand(x.movedim(-1, 1), p), operand(self.weight, p),
                     None, self.patch)
        return operand(y + self.bias.view(1, -1, 1, 1, 1), p).movedim(1, -1)


def triples(n: int) -> list[tuple[int, int, int]]:
    """Every (i, j, k) in range(n)³, lexicographically."""
    return [(i, j, k) for i in range(n) for j in range(n) for k in range(n)]


def geometry(grid, window: int, shifted: bool):
    """(window, shift, padded grid) per axis."""
    w = [min(window, g) for g in grid]
    s = [window // 2 if shifted and g > window else 0 for g in grid]
    padded = [math.ceil(g / k) * k for g, k in zip(grid, w)]
    return w, s, padded


def windows_of(x, w):
    """(B, D, H, W, C) -> (B, windows, tokens, C)."""
    b, d, h, wd, c = x.shape
    x = x.reshape(b, d // w[0], w[0], h // w[1], w[1], wd // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, -1, w[0] * w[1] * w[2], c)


def grid_of(x, w, dims):
    """(B, windows, tokens, C) -> (B, D, H, W, C)."""
    b = x.shape[0]
    d, h, wd = dims
    x = x.reshape(b, d // w[0], h // w[1], wd // w[2], w[0], w[1], w[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, wd, -1)


def region_mask(dims, w, s, device):
    """(windows, tokens, tokens): -100 between tokens of two regions."""
    labels = torch.zeros(dims, device=device)
    cuts = [[0, n - k, n - t, n] for n, k, t in zip(dims, w, s)]
    label = 0
    for i, j, k in triples(3):
        labels[cuts[0][i]:cuts[0][i + 1], cuts[1][j]:cuts[1][j + 1],
               cuts[2][k]:cuts[2][k + 1]] = label
        label += 1
    tokens = windows_of(labels[None, ..., None], w)[0, ..., 0]
    same = tokens[:, :, None] == tokens[:, None, :]
    return torch.where(same, 0.0, MASKED)


def offsets_index(window: int) -> torch.Tensor:
    """(w³, w³) row of the bias table of each (query, key) pair."""
    pos = torch.tensor(triples(window))
    rel = pos[:, None, :] - pos[None, :, :] + window - 1
    span = 2 * window - 1
    return (rel[..., 0] * span + rel[..., 1]) * span + rel[..., 2]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, precision: str):
        super().__init__()
        self.heads, self.window, self.precision = heads, window, precision
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.qkv = Linear(dim, 3 * dim, precision)
        self.proj = Linear(dim, dim, precision)

    def forward(self, x, mask):
        """x (B, windows, n, C); mask (windows, n, n) or None."""
        b, nw, n, c = x.shape
        h, p = self.heads, self.precision
        d = c // h
        qkv = self.qkv(x).reshape(b, nw, n, 3, h, d).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
        index = offsets_index(self.window)[:n, :n].to(x.device)
        bias = self.relative_position_bias_table[index].permute(2, 0, 1)
        step = max(1, CHUNK // (b * h * n * n))
        out = []
        for s in range(0, nw, step):
            scores = operand(operand(q[:, s:s + step], p) @ operand(
                k[:, s:s + step], p).transpose(-1, -2), p) + bias
            if mask is not None:
                scores = scores + mask[s:s + step, None]
            probs = torch.softmax(scores, dim=-1)
            out.append(operand(operand(probs, p) @ operand(
                v[:, s:s + step], p), p))
        out = torch.cat(out, dim=1).transpose(2, 3).reshape(b, nw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, precision: str):
        super().__init__()
        self.linear1 = Linear(dim, hidden, precision)
        self.linear2 = Linear(hidden, dim, precision)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, window, shifted, mlp_ratio, precision):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = LayerNorm(dim, precision)
        self.attn = Attention(dim, heads, window, precision)
        self.norm2 = LayerNorm(dim, precision)
        self.mlp = Mlp(dim, mlp_ratio * dim, precision)

    def attention(self, x):
        grid = list(x.shape[1:4])
        w, s, padded = geometry(grid, self.window, self.shifted)
        x = F.pad(x, (0, 0) + sum(((0, pg - g) for g, pg in
                                   reversed(list(zip(grid, padded)))), ()))
        rolled = any(s)
        if rolled:
            x = torch.roll(x, [-t for t in s], (1, 2, 3))
        mask = region_mask(padded, w, s, x.device) if rolled else None
        x = grid_of(self.attn(windows_of(x, w), mask), w, padded)
        if rolled:
            x = torch.roll(x, s, (1, 2, 3))
        return x[:, :grid[0], :grid[1], :grid[2]]

    def forward(self, x):
        x = x + self.attention(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Merging(nn.Module):
    def __init__(self, dim: int, precision: str):
        super().__init__()
        self.norm = LayerNorm(8 * dim, precision)
        self.reduction = Projection(8 * dim, 2 * dim, precision)

    def forward(self, x):
        d, h, w = x.shape[1:4]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       triples(2)], dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio, precision):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, heads, window, j % 2 == 1, mlp_ratio, precision)
            for j in range(depth))
        self.downsample = Merging(dim, precision)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.downsample(x)


class SwinEncoder(nn.Module):
    """The encoder and its feature head: (N, D, H, W, C) -> (N, F)."""

    def __init__(self, model_cfg: dict, precision: str):
        super().__init__()
        d = model_cfg
        dim = d["feature_size"]
        self.patch_embed = PatchEmbed(d["in_channels"], dim, d["patch_size"],
                                      precision)
        self.stages = len(d["depths"])
        for i, (depth, heads) in enumerate(zip(d["depths"], d["num_heads"])):
            self.add_module(f"layers{i + 1}", Stage(
                dim, depth, heads, d["window_size"], d["mlp_ratio"],
                precision))
            dim *= 2
        self.out_norm = LayerNorm(dim, precision, affine=False)
        self.feature_layer = Linear(dim, d["feature_layers"], precision)
        self.p_drop = d["image_dropout"]

    def forward(self, x, mask=None, generator=None):
        x = self.patch_embed(x)
        for i in range(self.stages):
            x = getattr(self, f"layers{i + 1}")(x)
        x = self.feature_layer(self.out_norm(x).mean(dim=(1, 2, 3)))
        if self.training:
            x = dropout(x, self.p_drop, generator, channels=False)
        return x


def build(model_cfg: dict, precision: str = "float32") -> nn.Module:
    d = model_cfg
    return BlendModel(SwinEncoder(d, precision), d["clinical_inputs"],
                      d["feature_layers"], d["classes"],
                      d["clinical_dropout"], precision)


def init_kind(name: str, shape) -> tuple[str, float]:
    """The encoder's Linears and bias tables: a normal of scale 0.02 cut at
    two deviations; the rest by the shared rule."""
    if name.endswith("relative_position_bias_table") or (
            len(shape) == 2 and name.startswith("image_model.layers")):
        return "lecun", INIT_FAN
    return common.init_kind(name, shape)


def layers(model_cfg: dict, spatial) -> list[dict]:
    """Each product of one volume's forward: the patch convolution, every
    block's qkv, its attention's two products over the padded windows, its
    output Linear and MLP, every merging's reduction, the feature layer."""
    d = model_cfg
    p, dim = d["patch_size"], d["feature_size"]
    grid = [s // p for s in spatial]
    out = [{"name": "patch_embed",
            "macs": math.prod(grid) * dim * d["in_channels"] * p ** 3,
            "first": True}]
    for i, depth in enumerate(d["depths"]):
        tokens = math.prod(grid)
        for j in range(depth):
            w, _, padded = geometry(grid, d["window_size"], j % 2 == 1)
            pairs = math.prod(padded) * math.prod(w)  # key-query pairs
            name = f"layers{i + 1}.blocks.{j}"
            out += [
                {"name": f"{name}.qkv", "macs": tokens * dim * 3 * dim,
                 "first": False},
                {"name": f"{name}.scores", "macs": pairs * dim,
                 "first": False},
                {"name": f"{name}.values", "macs": pairs * dim,
                 "first": False},
                {"name": f"{name}.proj", "macs": tokens * dim * dim,
                 "first": False},
                {"name": f"{name}.mlp",
                 "macs": 2 * tokens * dim * d["mlp_ratio"] * dim,
                 "first": False}]
        grid = [math.ceil(g / 2) for g in grid]
        out.append({"name": f"layers{i + 1}.downsample",
                    "macs": math.prod(grid) * 8 * dim * 2 * dim,
                    "first": False})
        dim *= 2
    out.append({"name": "feature_layer", "macs": dim * d["feature_layers"],
                "first": False})
    return out
