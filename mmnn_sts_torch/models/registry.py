"""Model factory keyed on config names (counterpart of
the JAX package's models/registry.py).

Ported so far: ``densenet121`` and ``tinydensenet`` image models, their
multimodal wrapping with the clinical MLP, and the clinical-only MLP, with
``ImageModel.dropout_prob`` as the JAX registry passes it (registry.py:41;
the multimodal model's clinical MLP keeps its own 0.2). Other model names,
and ``compute_dtype: bfloat16``, raise ``ConfigurationError``; ROADMAP.md
lists them as work to come.
"""

from __future__ import annotations

from torch import nn

from ..config import Config
from ..exceptions import ConfigurationError
from .densenet import densenet121, tiny_densenet
from .mlp import MLP
from .multimodal import MultiModalModel

_IMAGE_MODELS = {"densenet121": densenet121, "tinydensenet": tiny_densenet}


def _check_ported(cfg: Config):
    if cfg.tpu.compute_dtype != "float32":
        raise ConfigurationError(
            f"compute_dtype {cfg.tpu.compute_dtype!r} is not ported to "
            "mmnn_sts_torch yet (see ROADMAP.md); use float32"
        )


def build_image_model(cfg: Config, class_head: bool = True) -> nn.Module:
    """The image encoder; ``class_head=False`` leaves out its output layer
    (the multimodal model uses only its features)."""
    _check_ported(cfg)
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
    _check_ported(cfg)
    if num_tabular_inputs is None:
        num_tabular_inputs = count_tabular_inputs(cfg, images, preop, postop)
    if not images:
        return MLP(
            in_channels=num_tabular_inputs,
            out_channels=cfg.image_model.num_classes,
            feature_channels=cfg.image_model.feature_layers,
            dropout_prob=cfg.image_model.dropout_prob,
        )
    if preop or postop:
        return MultiModalModel(
            image_model=build_image_model(cfg, class_head=False),
            num_clinical_inputs=num_tabular_inputs,
            num_classes=cfg.image_model.num_classes,
            num_features=cfg.image_model.feature_layers,
            blend=blend,
        )
    return build_image_model(cfg)
