"""Model factory keyed on config names (counterpart of
the JAX package's models/registry.py).

Every image model name of the JAX registry (registry.py:29-111), matched
by the same prefixes in the same order: ``densenet121``, ``tinydensenet``,
``tinycnn``, ``monaidensenet`` (DenseNet121's blocks, vanilla head),
``densenet201``, ``densenet169``, ``densenet264`` (vanilla heads),
``seresnet50`` and ``r3d_18`` / ``r3d18``, each given exactly the
arguments the JAX registry gives it (``ImageModel.dropout_prob`` only
where it passes it; ``TPU.remat`` to the DenseNets), in
``TPU.compute_dtype`` (float32 or bfloat16); and, with no JAX
counterpart, ``swinvit``: Swin UNETR's 3D Swin-transformer encoder at its
published widths with DenseNet121's feature head (``models/swin.py``; 3D
only, a spatial size divisible by 32, no ``space`` or ``model`` axis).
Images with clinical predictors build the multimodal model, which only
``tinycnn``, ``tinydensenet``, ``densenet121`` (registry.py:22, 152-157)
and ``swinvit`` may encode; without images, the clinical MLP.
``ImageModel.spatial_dims`` (2 or 3) reaches every family but ``r3d_18``,
which the JAX registry builds 3D whatever it says (registry.py:106), and
``swinvit``, which refuses 2; a 2D model takes (N, H, W, C) inputs.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..exceptions import ConfigurationError
from .densenet import (
    DenseNet, densenet121, densenet169, densenet201, densenet264,
    tiny_densenet)
from .mlp import MLP
from .multimodal import MultiModalModel
from .resnet3d import ResNet3D18
from .seresnet import SEResNet50
from .swin import SwinViT, check_config
from .tinycnn import TinyCNN

_MULTIMODAL_COMPATIBLE = ("tinycnn", "tinydensenet", "densenet121",
                          "swinvit")
# the names whose JAX model takes TPU.use_pallas_fused_dense (the fused1
# bottleneck layout); the other DenseNets keep norm1 + conv1
_PALLAS_MODELS = ("densenet121", "tinydensenet")


def compute_dtype(cfg: Config) -> torch.dtype | None:
    """The models' compute dtype: None (float32, no casts) or bfloat16."""
    return torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16" else None


def npz_layout(cfg: Config) -> str:
    """The bottleneck layout of the JAX model this config builds, in which
    ``.npz`` files are written: ``"fused"`` where the JAX registry passes
    ``use_pallas`` and it is set, else ``"unfused"``."""
    name = cfg.image_model.name.lower()
    return ("fused" if cfg.tpu.use_pallas_fused_dense
            and name.startswith(_PALLAS_MODELS) else "unfused")


def build_image_model(cfg: Config, class_head: bool = True) -> nn.Module:
    """The image encoder; ``class_head=False`` leaves out its output layer
    (the multimodal model uses only its features)."""
    im = cfg.image_model
    name = im.name.lower()
    out = im.num_classes if class_head else None
    dtype, remat, sd = compute_dtype(cfg), cfg.tpu.remat, im.spatial_dims
    dense_kw = dict(in_channels=im.in_channels, out_channels=out, dtype=dtype,
                    remat=remat, spatial_dims=sd)
    if name.startswith("densenet121"):
        return densenet121(feature_channels=im.feature_layers,
                           dropout_prob=im.dropout_prob, **dense_kw)
    if name.startswith("tinydensenet"):
        return tiny_densenet(feature_channels=im.feature_layers,
                             dropout_prob=im.dropout_prob, **dense_kw)
    if name.startswith("tinycnn"):
        return TinyCNN(in_channels=im.in_channels, out_channels=out,
                       feature_channels=im.feature_layers,
                       dropout_prob=im.dropout_prob, dtype=dtype,
                       spatial_dims=sd)
    if name.startswith("monaidensenet"):
        return DenseNet(feature_channels=None, dropout_prob=im.dropout_prob,
                        **dense_kw)
    if name.startswith("densenet201"):
        return densenet201(**dense_kw)
    if name.startswith("densenet169"):
        return densenet169(**dense_kw)
    if name.startswith("densenet264"):
        return densenet264(**dense_kw)
    if name.startswith("seresnet50"):
        return SEResNet50(in_channels=im.in_channels,
                          num_classes=im.num_classes, dtype=dtype,
                          spatial_dims=sd)
    if name.startswith("swinvit"):
        check_config(sd, im.spatial_size, cfg.tpu.mesh_axes,
                     cfg.tpu.mesh_shape)
        return SwinViT(in_channels=im.in_channels, out_channels=out,
                       feature_channels=im.feature_layers,
                       dropout_prob=im.dropout_prob, dtype=dtype)
    if name.startswith(("r3d_18", "r3d18")):
        return ResNet3D18(in_channels=im.in_channels,
                          num_classes=im.num_classes, dtype=dtype)
    raise ConfigurationError(
        f"Model name not recognized: {name}\n\tSee config file for valid "
        "options"
    )


def count_tabular_inputs(cfg: Config, images: bool, preop: bool,
                         postop: bool) -> int:
    """Width of the clinical input, counted as the JAX registry counts it
    (registry.py:132-140, 158-162)."""
    pre = len(cfg.clinical_model.pre_op_predictors)
    post = len(cfg.clinical_model.post_op_predictors)
    if images or preop:
        return pre + (post if postop else 0)
    return post if postop else pre


def build_model(
    cfg: Config,
    images: bool,
    preop: bool,
    postop: bool,
    blend: bool,
    num_tabular_inputs: int | None = None,
) -> nn.Module:
    """The task model: clinical-only MLP, image-only encoder, or multimodal
    fusion when images are combined with clinical predictors."""
    if num_tabular_inputs is None:
        num_tabular_inputs = count_tabular_inputs(cfg, images, preop, postop)
    if not images:
        return MLP(
            in_channels=num_tabular_inputs,
            out_channels=cfg.image_model.num_classes,
            feature_channels=cfg.image_model.feature_layers,
            dropout_prob=cfg.image_model.dropout_prob,
            dtype=compute_dtype(cfg),
        )
    if preop or postop:
        image_model = build_image_model(cfg, class_head=False)
        if not cfg.image_model.name.lower().startswith(_MULTIMODAL_COMPATIBLE):
            raise ConfigurationError(
                "Image models used to build multimodal models must be one of "
                "'tinycnn', 'tinydensenet', 'densenet121' or 'swinvit'"
            )
        return MultiModalModel(
            image_model=image_model,
            num_clinical_inputs=num_tabular_inputs,
            num_classes=cfg.image_model.num_classes,
            num_features=cfg.image_model.feature_layers,
            blend=blend,
            dtype=compute_dtype(cfg),
        )
    return build_image_model(cfg)
