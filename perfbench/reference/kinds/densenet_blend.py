"""Reference family ``densenet_blend``: the MMNN_STS model, the
``densenet`` family's DenseNet-3D with its feature head (ReLU, global
average pool, Linear to ``feature_layers``, dropout) as the image model
of the shared ``BlendModel`` (the clinical MLP and the three gradient-
blending heads). Dropout draws in the model's order: the dense layers',
the feature head's, then the clinical MLP's six."""

from __future__ import annotations

from torch import nn

from perfbench.reference.common import BlendModel
from perfbench.reference.kinds import densenet


def build(model_cfg: dict, precision: str = "float32") -> nn.Module:
    d = model_cfg
    image = densenet.DenseNet3D(feature_channels=d["feature_layers"],
                                out_channels=None,
                                **densenet.arguments(d, precision))
    return BlendModel(image, d["clinical_inputs"], d["feature_layers"],
                      d["classes"], d["clinical_dropout"], precision)


def layers(model_cfg: dict, spatial) -> list[dict]:
    out, ch = densenet.encoder_layers(model_cfg, spatial)
    out.append({"name": "feature_layer",
                "macs": ch * model_cfg["feature_layers"], "first": False})
    return out
