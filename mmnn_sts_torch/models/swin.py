"""Swin UNETR's 3D Swin-transformer encoder with the multimodal model's
feature head (Hatamizadeh et al. 2022, arXiv:2201.01266; MONAI
``SwinTransformer``, the ``swinViT`` of ``SwinUNETR``, ``use_v2`` off).

The registry's ``swinvit`` fixes the published widths: ``feature_size``
48, depths 2-2-2-2, heads 3-6-12-24 (a head of 16 everywhere), window 7³,
patch 2³, MLP ratio 4, a qkv bias, every drop rate 0, ``normalize`` on.
Tokens are ``(N, D, H, W, C)`` (channels last); the residual stream stays
float32.

* ``patch_embed``: Conv3d(in_channels -> 48, kernel 2, stride 2) with a
  bias, no patch norm.
* ``layers1`` .. ``layers4``: each ``blocks`` of Swin blocks, then
  ``downsample``, the patch merging: C doubles and the grid halves, so at
  96³ the stages run at 48³, 24³, 12³ and 6³ and leave 768 channels at 3³.
* A block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``, the MLP
  ``linear1`` (C -> 4C), exact GELU, ``linear2`` (4C -> C).
* The attention (MONAI's ``SwinTransformerBlock.forward_part1``): the
  layer-normed grid padded with zeros up to whole windows; on odd blocks
  rolled by -3 on each axis; windows of 7³ tokens; the ``qkv`` Linear
  (bias on), ``softmax(q kᵀ / 4 + bias + mask) v`` on
  ``ops/window_attention``, the ``proj`` Linear; windows back, rolled back,
  cropped. The bias is ``relative_position_bias_table[index]``, the table
  (2·7 − 1)³ × heads; the mask is -100 between tokens that the shift
  brought from different regions (MONAI's ``compute_mask``). An axis no
  longer than the window (the 6³ stage) takes a window of the grid's size
  and no shift.
* **Departure from Liu et al., kept as MONAI has it:** where the window
  shrinks to n < 343 tokens, the bias index is the ``[:n, :n]`` corner of
  the 7³ window's index, not the index of the smaller window.
* ``downsample`` (MONAI's ``PatchMergingV2``): the eight distinct offsets
  of each 2³ cell concatenated (d, h, w in ``itertools.product`` order),
  LayerNorm(8C), ``reduction`` Linear(8C -> 2C, no bias).
* The head: a LayerNorm without affine of the last stage's output, the
  mean over its tokens, ``feature_layer`` Linear(768 -> feature_channels),
  dropout (as DenseNet121's feature head); ``out`` where a class head is
  asked for.

Initialisation as MONAI's: the transformer's Linears and the bias table
truncated normal (std 0.02, cut at ±2), biases zero, LayerNorms at ones and
zeros; the patch convolution and the head as the port's other models.

Dtypes: the Linears, the attention and the patch convolution compute in
``dtype`` (``TPU.compute_dtype``); LayerNorm computes in float32 and gives
the compute dtype; the residual stream and the patch merging's input are
float32. Masked rows of a wrap-padded batch need nothing: no number of one
sample depends on another's.

The relative-position index is a non-persistent buffer, made anew
wherever the module is moved (so also right after a ``to_empty``); the
shift masks are made at the first forward on a grid and kept on the
block. Neither is in the ``state_dict``; a CUDA graph captured later
reads the kept tensors. Refused, with ``ConfigurationError``: Grad-CAM, 2D,
a spatial size not divisible by 32 and a mesh whose ``space`` or ``model``
axis is not 1.
"""

from __future__ import annotations

import itertools

import torch
from torch import nn
from torch.nn import functional as F

from ..exceptions import ConfigurationError
from ..ops import window_attention
from .common import Dropout, LayerNorm, Linear, conv, dense
from .seresnet import no_gradcam

FEATURE_SIZE = 48
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
WINDOW = 7
PATCH = 2
MLP_RATIO = 4
INIT_STD = 0.02


def check_config(spatial_dims: int, spatial_size, mesh_axes,
                 mesh_shape) -> None:
    """Raise ``ConfigurationError`` where the encoder cannot run."""
    if spatial_dims != 3:
        raise ConfigurationError("swinvit is a 3D model: spatial_dims must "
                                 f"be 3, got {spatial_dims}")
    if any(s % 32 for s in spatial_size):
        raise ConfigurationError(
            "swinvit needs a spatial size divisible by 32 (patch 2 and four "
            f"patch mergings), got {list(spatial_size)}")
    for axis, size in zip(mesh_axes, mesh_shape):
        if axis in ("space", "model") and size != 1:
            raise ConfigurationError(
                f"swinvit runs on the 'data' axis alone: the mesh's {axis!r} "
                f"axis is {size}")


def _linear(n_in: int, n_out: int, dtype, bias: bool = True) -> Linear:
    layer = Linear(n_in, n_out, bias=bias)
    nn.init.trunc_normal_(layer.weight, std=INIT_STD)
    if bias:
        nn.init.zeros_(layer.bias)
    layer.compute_dtype = dtype
    return layer


def window_geometry(grid, window: int, shift: int):
    """(window, shift) per axis, MONAI's ``get_window_size``: an axis no
    longer than the window takes a window of its size and no shift."""
    return (tuple(g if g <= window else window for g in grid),
            tuple(0 if g <= window else shift for g in grid))


def window_partition(x, w):
    """(B, D, H, W, C) -> (B, windows, tokens, C), windows and their tokens
    in (d, h, w) order."""
    b, d, h, wd, c = x.shape
    x = x.view(b, d // w[0], w[0], h // w[1], w[1], wd // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, -1, w[0] * w[1] * w[2], c)


def window_reverse(windows, w, dims):
    """(B, windows, tokens, C) -> (B, D, H, W, C) of ``dims`` (D, H, W)."""
    b, (d, h, wd) = windows.shape[0], dims
    x = windows.view(b, d // w[0], h // w[1], wd // w[2], w[0], w[1], w[2],
                     -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, wd, -1)


def relative_position_index(window: int) -> torch.Tensor:
    """(window³, window³) index into the (2·window − 1)³ bias table."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) \
        + (window - 1)
    span = 2 * window - 1
    return rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]


def shift_mask(dims, w, s, device) -> torch.Tensor:
    """(windows, tokens, tokens): 0 within a region of the shifted grid,
    ``MASKED`` across two (MONAI's ``compute_mask``)."""
    img = torch.zeros((1,) + tuple(dims) + (1,), device=device)
    regions = [(slice(-k), slice(-k, -t), slice(-t, None))
               for k, t in zip(w, s)]
    for cnt, (a, b, c) in enumerate(itertools.product(*regions)):
        img[:, a, b, c, :] = cnt
    win = window_partition(img, w)[0, :, :, 0]
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return torch.where(diff != 0, window_attention.MASKED, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, dtype):
        super().__init__()
        self.heads = heads
        self.window = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table,
                              std=INIT_STD)
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)
        self.qkv = _linear(dim, 3 * dim, dtype)
        self.proj = _linear(dim, dim, dtype)

    def _apply(self, fn, recurse=True):
        # the index is made anew wherever the module goes, so that it holds
        # its values after a ``to_empty`` too
        super()._apply(fn, recurse)
        self.relative_position_index = relative_position_index(
            self.window).to(self.relative_position_bias_table.device)
        return self

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) relative-position bias of an n-token window."""
        index = self.relative_position_index[:n, :n].reshape(-1)
        return self.relative_position_bias_table.index_select(
            0, index).view(n, n, -1).permute(2, 0, 1)

    def forward(self, x, mask=None):
        """x: (B, windows, tokens, C) -> the same."""
        return self.proj(window_attention.window_attention(
            self.qkv(x), self.bias(x.shape[2]), mask, self.heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.linear1 = _linear(dim, hidden, dtype)
        self.linear2 = _linear(hidden, dim, dtype)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, MLP_RATIO * dim, dtype)
        self._masks = {}

    def _mask(self, dims, w, s, dtype, device):
        key = (tuple(dims), w, s, dtype, device)
        if key not in self._masks:
            self._masks[key] = window_attention.padded_mask(
                shift_mask(dims, w, s, device), dtype)
        return self._masks[key]

    def attend(self, h):
        """The shifted-window attention of the layer-normed grid h."""
        grid = h.shape[1:4]
        w, s = window_geometry(grid, self.window, self.shift)
        pads = [-g % k for g, k in zip(grid, w)]
        if any(pads):
            h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims = h.shape[1:4]
        shifted = any(s)
        if shifted:
            h = torch.roll(h, tuple(-t for t in s), (1, 2, 3))
        mask = (self._mask(dims, w, s, h.dtype, h.device) if shifted
                else None)
        h = window_reverse(self.attn(window_partition(h, w), mask), w, dims)
        if shifted:
            h = torch.roll(h, s, (1, 2, 3))
        if any(pads):
            h = h[:, :grid[0], :grid[1], :grid[2]]
        return h

    def forward(self, x):
        x = x + self.attend(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.norm = LayerNorm(8 * dim, dtype)
        self.reduction = _linear(8 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x):
        # every grid is even: the spatial size is a multiple of 32
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], -1)
        return self.reduction(self.norm(x)).float()


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2,
                      dtype) for j in range(depth))
        self.downsample = PatchMerging(dim, dtype)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.downsample(x)


class SwinViT(nn.Module):
    """The encoder and its feature head; ``out_channels=None`` builds no
    ``out`` head (the multimodal model takes the features). ``feature_size``,
    ``depths``, ``heads`` and ``window`` are the published ones unless a
    test shrinks them."""

    def __init__(self, in_channels: int = 2, out_channels: int | None = None,
                 feature_channels: int = 12, dropout_prob: float = 0.2,
                 dtype: torch.dtype | None = None,
                 feature_size: int = FEATURE_SIZE, depths=DEPTHS,
                 heads=HEADS, window: int = WINDOW):
        super().__init__()
        self.patch_embed = conv(in_channels, feature_size, PATCH,
                                stride=PATCH, dtype=dtype, use_bias=True)
        dim = feature_size
        for i, (depth, h) in enumerate(zip(depths, heads)):
            self.add_module(f"layers{i + 1}",
                            SwinStage(dim, depth, h, window, dtype))
            dim *= 2
        self.stages = len(depths)
        self.out_norm = LayerNorm(dim, dtype, affine=False)
        self.feature_layer = dense(dim, feature_channels, dtype)
        self.feature_dropout = Dropout(dropout_prob)
        if out_channels is not None:
            self.out = dense(feature_channels, out_channels, dtype)

    def forward(self, x, return_features: bool = False, sample_mask=None,
                generator=None, capture_gradcam: bool = False):
        """x: (N, D, H, W, C) -> (N, feature_channels) features, or the
        ``out`` head's logits."""
        if capture_gradcam:
            no_gradcam("swinvit")
        x = self.patch_embed(x.movedim(-1, 1)).permute(0, 2, 3, 4, 1).float()
        for i in range(self.stages):
            x = getattr(self, f"layers{i + 1}")(x)
        feats = self.out_norm(x).mean(dim=(1, 2, 3))
        feats = self.feature_dropout(self.feature_layer(feats), generator)
        return feats if return_features else self.out(feats)
