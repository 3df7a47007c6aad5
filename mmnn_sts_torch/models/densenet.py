"""3D DenseNet with the custom feature head (counterpart of
the JAX package's models/densenet.py).

* ``DenseLayer``: fused BN -> ReLU -> 1x1x1 conv (the bottleneck, through
  ``ops.fused_dense``) -> BN -> ReLU -> 3x3x3 conv -> channel dropout ->
  concat with the input.
* ``Transition``: BN -> ReLU -> 1x1x1 conv (in // 2) -> avg pool 2.
* ``DenseNet``: conv0 (7, stride 2, pad 3) -> BN -> ReLU -> max pool
  (3, 2, 1) -> blocks and transitions -> norm5, then the ``features`` head
  (ReLU -> global average pool -> Linear(feature_channels) -> dropout) and
  the ``class_layers`` head (Linear(out_channels)).

Train mode is ``module.training``; ``sample_mask`` reaches every BatchNorm
and the dropouts draw from ``generator``. The stem is a plain strided
convolution with the logical (7, 7, 7) kernel; the JAX package's
space-to-depth form of it is a TPU layout choice with the same numbers.
Submodule names follow the JAX package's parameter paths, so ``convert.py``
maps checkpoints name for name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.fused_dense import bn_relu_conv1x1
from .common import (
    CHANNELS_LAST,
    BN_EPS,
    BatchNorm,
    Dropout,
    avg_pool,
    compute_batch_stats,
    conv,
    dense,
    global_avg_pool,
    kaiming_normal_,
    max_pool,
    update_running_stats,
)


class FusedBottleneck(nn.Module):
    """BN + ReLU + 1x1x1 conv in one call of the fused op, in train mode on
    the batch statistics of x (then the running-stat update), in eval mode
    on the running ones (densenet.py:151-203). Masked rows are not zeroed
    here, as in the JAX module.

    State mirrors the JAX ``fused1`` layout: ``scale``, ``bias`` and
    ``kernel`` (Cin, Cout), plus the running ``mean`` and ``var``.
    ``convert.py`` fills it from either JAX layout (``fused1`` or the
    unfused ``norm1`` + ``conv1``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(in_channels))
        self.kernel = nn.Parameter(kaiming_normal_(
            torch.empty(in_channels, out_channels), in_channels))
        self.register_buffer("mean", torch.zeros(in_channels))
        self.register_buffer("var", torch.ones(in_channels))

    def forward(self, x, sample_mask=None):
        """x: (N, C, D, H, W), channels-last in memory."""
        if self.training:
            mean, var, unbiased, any_valid = compute_batch_stats(x, sample_mask)
            update_running_stats(self.mean, self.var, mean, unbiased,
                                 any_valid)
        else:
            mean, var = self.mean, self.var
        y = bn_relu_conv1x1(
            x.permute(0, 2, 3, 4, 1), self.scale, self.bias, mean, var,
            self.kernel.to(x.dtype), eps=BN_EPS,
        )
        return y.permute(0, 4, 1, 2, 3)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int,
                 dropout_prob: float = 0.0):
        super().__init__()
        self.fused1 = FusedBottleneck(in_channels, bn_size * growth_rate)
        self.norm2 = BatchNorm(bn_size * growth_rate)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3, padding=1)
        self.dropout = Dropout(dropout_prob, channels=True)

    def forward(self, x, sample_mask=None, generator=None):
        y = F.relu(self.norm2(self.fused1(x, sample_mask), sample_mask))
        y = self.dropout(self.conv2(y), generator)
        return torch.cat([x, y.contiguous(memory_format=CHANNELS_LAST)], dim=1)


class Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = BatchNorm(in_channels)
        self.conv = conv(in_channels, out_channels, 1)

    def forward(self, x, sample_mask=None):
        return avg_pool(self.conv(F.relu(self.norm(x, sample_mask))), 2, 2)


class DenseNet(nn.Module):
    """3D DenseNet with backbone / features / class_layers split.

    ``out_channels=None`` builds no ``class_layers`` head: inside the
    multimodal model the image encoder only contributes its features, and
    the JAX package's encoder then has no ``out`` parameters either."""

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int | None = 2,
        feature_channels: int = 12,
        init_features: int = 64,
        growth_rate: int = 32,
        block_config: Sequence[int] = (6, 12, 24, 16),
        bn_size: int = 4,
        dropout_prob: float = 0.0,
    ):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = conv(in_channels, init_features, 7, stride=2, padding=3)
        self.norm0 = BatchNorm(init_features)
        ch = init_features
        for i, num_layers in enumerate(self.block_config):
            for j in range(num_layers):
                self.add_module(
                    f"block{i + 1}_layer{j + 1}",
                    DenseLayer(ch, growth_rate, bn_size, dropout_prob))
                ch += growth_rate
            if i == len(self.block_config) - 1:
                self.norm5 = BatchNorm(ch)
            else:
                self.add_module(f"transition{i + 1}", Transition(ch, ch // 2))
                ch //= 2
        self.feature_layer = dense(ch, feature_channels)
        self.feature_dropout = Dropout(dropout_prob)
        if out_channels is not None:
            self.out = dense(feature_channels, out_channels)

    def backbone(self, x, sample_mask=None, generator=None):
        """x: (N, C, D, H, W) channels-last -> final BN'd feature map."""
        x = max_pool(F.relu(self.norm0(self.conv0(x), sample_mask)), 3, 2, 1)
        for i, num_layers in enumerate(self.block_config):
            # pooling may hand back another memory format; the dense block's
            # bottlenecks need channels-last, so restore it once per block
            x = x.contiguous(memory_format=CHANNELS_LAST)
            for j in range(num_layers):
                x = getattr(self, f"block{i + 1}_layer{j + 1}")(
                    x, sample_mask, generator)
            if i == len(self.block_config) - 1:
                x = self.norm5(x, sample_mask)
            else:
                x = getattr(self, f"transition{i + 1}")(x, sample_mask)
        return x

    def features(self, x, generator=None):
        return self.feature_dropout(
            self.feature_layer(global_avg_pool(F.relu(x))), generator)

    def class_layers(self, x):
        return self.out(x)

    def forward(self, x, return_features: bool = False, sample_mask=None,
                generator=None):
        """x: (N, D, H, W, C), the JAX package's layout."""
        feats = self.features(
            self.backbone(x.permute(0, 4, 1, 2, 3), sample_mask, generator),
            generator)
        return feats if return_features else self.class_layers(feats)


def bottleneck_shapes(model: DenseNet, batch: int, size: int = 64):
    """(block, M, Cin) of each bottleneck call (one ``bn_relu_conv1x1``) of
    ``model``'s forward on ``batch`` cubes of side ``size``, in call order:
    Cin is the layer's input channels, M the voxels of its block's feature
    map (the stem's stride 2 and the max pool's, then a halving per
    transition)."""
    shapes = []
    for i, num_layers in enumerate(model.block_config):
        side = size // 4 >> i
        for j in range(num_layers):
            layer = getattr(model, f"block{i + 1}_layer{j + 1}")
            shapes.append((i + 1, batch * side ** 3,
                           layer.fused1.kernel.shape[0]))
    return shapes


def densenet121(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 24, 16), **kw)


def tiny_densenet(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 4), **kw)
