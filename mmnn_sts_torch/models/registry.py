"""Model factory keyed on config names (counterpart of
the JAX package's models/registry.py).

Ported so far: ``densenet121`` and ``tinydensenet`` image models, their
multimodal wrapping with the clinical MLP, and the clinical-only MLP, with
``ImageModel.dropout_prob`` as the JAX registry passes it (registry.py:41;
the multimodal model's clinical MLP keeps its own 0.2), each in
``TPU.compute_dtype`` (float32 or bfloat16, registry.py:25-26). Other model
names raise ``ConfigurationError``; ROADMAP.md lists them as work to come.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..exceptions import ConfigurationError
from .densenet import densenet121, tiny_densenet
from .mlp import MLP
from .multimodal import MultiModalModel

_IMAGE_MODELS = {"densenet121": densenet121, "tinydensenet": tiny_densenet}


def compute_dtype(cfg: Config) -> torch.dtype | None:
    """The models' compute dtype: None (float32, no casts) or bfloat16."""
    return torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16" else None


def build_image_model(cfg: Config, class_head: bool = True) -> nn.Module:
    """The image encoder; ``class_head=False`` leaves out its output layer
    (the multimodal model uses only its features)."""
    im = cfg.image_model
    name = im.name.lower()
    if im.spatial_dims != 3:
        raise ConfigurationError(
            f"spatial_dims {im.spatial_dims} is not ported to mmnn_sts_torch "
            "yet (see ROADMAP.md)"
        )
    for prefix, factory in _IMAGE_MODELS.items():
        if name.startswith(prefix):
            return factory(
                in_channels=im.in_channels,
                out_channels=im.num_classes if class_head else None,
                feature_channels=im.feature_layers,
                dropout_prob=im.dropout_prob,
                dtype=compute_dtype(cfg),
            )
    raise ConfigurationError(
        f"Model name {name!r} is not ported to mmnn_sts_torch yet "
        f"(ported: {', '.join(_IMAGE_MODELS)}; see ROADMAP.md)"
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
        return MultiModalModel(
            image_model=build_image_model(cfg, class_head=False),
            num_clinical_inputs=num_tabular_inputs,
            num_classes=cfg.image_model.num_classes,
            num_features=cfg.image_model.feature_layers,
            blend=blend,
            dtype=compute_dtype(cfg),
        )
    return build_image_model(cfg)
