"""2D or 3D DenseNet with the custom feature head or the vanilla one
(counterpart of the JAX package's models/densenet.py). ``spatial_dims``
(``ImageModel.spatial_dims``) is 3 for (N, D, H, W, C) volumes and 2 for
(N, H, W, C) images: every convolution, pool and channel dropout then
works in 2D, and the bottleneck's M is B x H x W instead of B x D x H x W.

* ``DenseLayer``: fused BN -> ReLU -> 1x1(x1) conv (the bottleneck,
  through ``ops.fused_dense``) -> BN -> ReLU -> 3x3(x3) conv -> channel
  dropout -> concat with the input.
* ``Transition``: BN -> ReLU -> 1x1(x1) conv (in // 2) -> avg pool 2.
* ``DenseNet``: conv0 (7, stride 2, pad 3) -> BN -> ReLU -> max pool
  (3, 2, 1) -> blocks and transitions -> norm5, then the ``features`` head
  (ReLU -> global average pool -> Linear(feature_channels) -> dropout; with
  ``feature_channels=None`` the vanilla head, ReLU -> global average pool
  only, densenet.py:333-339) and the ``class_layers`` head
  (Linear(out_channels)).
* ``remat`` (``TPU.remat``): in train mode each dense layer and transition
  but the Grad-CAM target runs under ``torch.utils.checkpoint``
  (``common.remat_call``), so the backward recomputes its forward, the
  bottleneck's kernel launch included (densenet.py:284-307). Numbers do
  not change.

Train mode is ``module.training``; ``sample_mask`` reaches every BatchNorm
and the dropouts draw from ``generator``. ``capture_gradcam`` also returns
the Grad-CAM target, the last dense layer's 3x3x3 convolution output. The stem is a plain strided
convolution with the logical (7, 7, 7) kernel; the JAX package's
space-to-depth form of it is a TPU layout choice with the same numbers.
``dtype`` (None or ``torch.bfloat16``) is the compute dtype of every
convolution, BatchNorm output, bottleneck and dense layer, as the JAX
module's ``dtype`` (densenet.py:110-111, 146-147, 199-202, 338-342).
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
    BN_EPS,
    BatchNorm,
    Dropout,
    avg_pool,
    channels_last,
    compute_batch_stats,
    conv,
    dense,
    global_avg_pool,
    kaiming_normal_,
    max_pool,
    remat_call,
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
    unfused ``norm1`` + ``conv1``). With a ``dtype``, x and the kernel
    reach the fused op in it, and so does the output."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(in_channels))
        self.kernel = nn.Parameter(kaiming_normal_(
            torch.empty(in_channels, out_channels), in_channels))
        self.register_buffer("mean", torch.zeros(in_channels))
        self.register_buffer("var", torch.ones(in_channels))

    def forward(self, x, sample_mask=None):
        """x: (N, C, *spatial), channels-last in memory."""
        if self.training:
            mean, var, unbiased, any_valid = compute_batch_stats(x, sample_mask)
            update_running_stats(self.mean, self.var, mean, unbiased,
                                 any_valid)
        else:
            mean, var = self.mean, self.var
        dtype = self.compute_dtype or x.dtype
        y = bn_relu_conv1x1(
            x.to(dtype).movedim(1, -1), self.scale, self.bias, mean,
            var, self.kernel.to(dtype), eps=BN_EPS,
        )
        return y.movedim(-1, 1)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int,
                 dropout_prob: float = 0.0, dtype: torch.dtype | None = None,
                 spatial_dims: int = 3):
        super().__init__()
        self.fused1 = FusedBottleneck(in_channels, bn_size * growth_rate,
                                      dtype)
        self.norm2 = BatchNorm(bn_size * growth_rate, dtype)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3, padding=1,
                          dtype=dtype, spatial_dims=spatial_dims)
        self.dropout = Dropout(dropout_prob, channels=True)

    def forward(self, x, sample_mask=None, generator=None, captured=None):
        """``captured``: a list that receives the 3x3(x3) convolution's
        output (before dropout), the Grad-CAM target of the last layer."""
        y = self.conv2(F.relu(self.norm2(self.fused1(x, sample_mask),
                                         sample_mask)))
        if captured is not None:
            captured.append(y)
        y = self.dropout(y, generator)
        return torch.cat([x, channels_last(y)], dim=1)


class Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype | None = None, spatial_dims: int = 3):
        super().__init__()
        self.norm = BatchNorm(in_channels, dtype)
        self.conv = conv(in_channels, out_channels, 1, dtype=dtype,
                         spatial_dims=spatial_dims)

    def forward(self, x, sample_mask=None):
        return avg_pool(self.conv(F.relu(self.norm(x, sample_mask))), 2, 2)


class DenseNet(nn.Module):
    """N-D DenseNet with backbone / features / class_layers split.

    ``out_channels=None`` builds no ``class_layers`` head: inside the
    multimodal model the image encoder only contributes its features, and
    the JAX package's encoder then has no ``out`` parameters either.
    ``feature_channels=None`` builds the vanilla head: no ``feature_layer``
    and no feature dropout, ``out`` over the final channels."""

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int | None = 2,
        feature_channels: int | None = 12,
        init_features: int = 64,
        growth_rate: int = 32,
        block_config: Sequence[int] = (6, 12, 24, 16),
        bn_size: int = 4,
        dropout_prob: float = 0.0,
        dtype: torch.dtype | None = None,
        remat: bool = False,
        spatial_dims: int = 3,
    ):
        super().__init__()
        self.block_config = tuple(block_config)
        self.remat = remat
        self.spatial_dims = spatial_dims
        self.conv0 = conv(in_channels, init_features, 7, stride=2, padding=3,
                          dtype=dtype, spatial_dims=spatial_dims)
        self.norm0 = BatchNorm(init_features, dtype)
        ch = init_features
        for i, num_layers in enumerate(self.block_config):
            for j in range(num_layers):
                self.add_module(
                    f"block{i + 1}_layer{j + 1}",
                    DenseLayer(ch, growth_rate, bn_size, dropout_prob, dtype,
                               spatial_dims))
                ch += growth_rate
            if i == len(self.block_config) - 1:
                self.norm5 = BatchNorm(ch, dtype)
            else:
                self.add_module(f"transition{i + 1}",
                                Transition(ch, ch // 2, dtype, spatial_dims))
                ch //= 2
        self.vanilla = feature_channels is None
        if not self.vanilla:
            self.feature_layer = dense(ch, feature_channels, dtype)
            self.feature_dropout = Dropout(dropout_prob)
            ch = feature_channels
        if out_channels is not None:
            self.out = dense(ch, out_channels, dtype)

    def backbone(self, x, sample_mask=None, generator=None, captured=None):
        """x: (N, C, *spatial) channels-last -> final BN'd feature map. The
        last dense layer appends its Grad-CAM target to ``captured``, where
        one is given (densenet.py:309-323). With ``remat`` in train mode
        every other dense layer and each transition run under
        ``remat_call``."""
        last = len(self.block_config) - 1
        remat = self.remat and self.training
        x = max_pool(F.relu(self.norm0(self.conv0(x), sample_mask)), 3, 2, 1)
        for i, num_layers in enumerate(self.block_config):
            # pooling may hand back another memory format; the dense block's
            # bottlenecks need channels-last, so restore it once per block
            x = channels_last(x)
            for j in range(num_layers):
                target = i == last and j == num_layers - 1
                layer = getattr(self, f"block{i + 1}_layer{j + 1}")
                if remat and not target:
                    x = remat_call(layer, x, sample_mask, generator,
                                   generator=generator)
                else:
                    x = layer(x, sample_mask, generator,
                              captured if target else None)
            if i == last:
                x = self.norm5(x, sample_mask)
            elif remat:
                x = remat_call(getattr(self, f"transition{i + 1}"), x,
                               sample_mask)
            else:
                x = getattr(self, f"transition{i + 1}")(x, sample_mask)
        return x

    def features(self, x, generator=None):
        x = global_avg_pool(F.relu(x))
        if self.vanilla:
            return x
        return self.feature_dropout(self.feature_layer(x), generator)

    def class_layers(self, x):
        return self.out(x)

    def forward(self, x, return_features: bool = False, sample_mask=None,
                generator=None, capture_gradcam: bool = False):
        """x: (N, *spatial, C), the JAX package's layout. With
        ``capture_gradcam``, returns ``(out, act)``: ``act`` is the last
        dense layer's 3x3(x3) convolution output, (N, growth, *spatial'),
        a tensor of the graph that the gradients of ``out`` reach."""
        captured = [] if capture_gradcam else None
        feats = self.features(
            self.backbone(x.movedim(-1, 1), sample_mask, generator,
                          captured),
            generator)
        out = feats if return_features else self.class_layers(feats)
        return (out, captured[0]) if capture_gradcam else out


def bottleneck_shapes(model: DenseNet, batch: int, size: int = 64):
    """(block, M, Cin) of each bottleneck call (one ``bn_relu_conv1x1``) of
    ``model``'s forward (any ``block_config``) on ``batch`` cubes (or
    squares, for a 2D model) of side ``size``, in call order: Cin is the
    layer's input channels, M the voxels of its block's feature map (the
    stem's stride 2 and the max pool's, then a halving per transition)."""
    shapes = []
    for i, num_layers in enumerate(model.block_config):
        side = size // 4 >> i
        for j in range(num_layers):
            layer = getattr(model, f"block{i + 1}_layer{j + 1}")
            shapes.append((i + 1, batch * side ** model.spatial_dims,
                           layer.fused1.kernel.shape[0]))
    return shapes


def densenet121(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 24, 16), **kw)


def tiny_densenet(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 4), **kw)


def densenet169(**kw) -> DenseNet:
    """The standard blocks with the vanilla head, as the JAX registry
    builds densenet169, 201 and 264 (registry.py:77-98)."""
    return DenseNet(block_config=(6, 12, 32, 32), feature_channels=None, **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 48, 32), feature_channels=None, **kw)


def densenet264(**kw) -> DenseNet:
    return DenseNet(block_config=(6, 12, 64, 48), feature_channels=None, **kw)
