"""Multimodal fusion model: 3D image encoder + clinical MLP (counterpart of
the JAX package's models/multimodal.py).

Both encoders contribute their ``features``; fusion is
concat(image_features, clinical_features) -> Linear(2F, C). Blend mode adds
per-modality heads and stacks (multimodal, image, clinical) into a
(3, N, C) tensor; head 0 is the multimodal head (multimodal.py:76-86). The
clinical MLP's dropout is ``clinical_dropout_prob``, 0.2 by default whatever
the image model's (multimodal.py:32-37).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import dense
from .mlp import MLP


class MultiModalModel(nn.Module):
    def __init__(self, image_model: nn.Module, num_clinical_inputs: int,
                 num_classes: int = 2, num_features: int = 12,
                 blend: bool = False, clinical_dropout_prob: float = 0.2):
        super().__init__()
        self.blend = blend
        self.image_model = image_model
        self.clinical_model = MLP(in_channels=num_clinical_inputs,
                                  out_channels=None,
                                  feature_channels=num_features,
                                  dropout_prob=clinical_dropout_prob)
        self.output_head = dense(2 * num_features, num_classes)
        if blend:
            self.image_output_head = dense(num_features, num_classes)
            self.clinical_output_head = dense(num_features, num_classes)

    def forward(self, inputs: dict, sample_mask=None, generator=None):
        """inputs: {"image": (N, D, H, W, C), "clinical": (N, P)}."""
        image_features = self.image_model(
            inputs["image"], return_features=True, sample_mask=sample_mask,
            generator=generator)
        clinical_features = self.clinical_model(
            inputs["clinical"], return_features=True, sample_mask=sample_mask,
            generator=generator)
        out = self.output_head(
            torch.cat([image_features, clinical_features], dim=1))
        if self.blend:
            out = torch.stack([
                out,
                self.image_output_head(image_features),
                self.clinical_output_head(clinical_features),
            ])
        return out
