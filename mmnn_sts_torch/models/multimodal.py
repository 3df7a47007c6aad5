"""Multimodal fusion model: 3D image encoder + clinical MLP (counterpart of
the JAX package's models/multimodal.py), eval mode.

Both encoders contribute their ``features``; fusion is
concat(image_features, clinical_features) -> Linear(2F, C). Blend mode adds
per-modality heads and stacks (multimodal, image, clinical) into a
(3, N, C) tensor; head 0 is the multimodal head (multimodal.py:76-86).
"""

from __future__ import annotations

import torch
from torch import nn

from .mlp import MLP


class MultiModalModel(nn.Module):
    def __init__(self, image_model: nn.Module, num_clinical_inputs: int,
                 num_classes: int = 2, num_features: int = 12,
                 blend: bool = False):
        super().__init__()
        self.blend = blend
        self.image_model = image_model
        self.clinical_model = MLP(in_channels=num_clinical_inputs,
                                  out_channels=None,
                                  feature_channels=num_features)
        self.output_head = nn.Linear(2 * num_features, num_classes)
        if blend:
            self.image_output_head = nn.Linear(num_features, num_classes)
            self.clinical_output_head = nn.Linear(num_features, num_classes)

    def forward(self, inputs: dict):
        """inputs: {"image": (N, D, H, W, C), "clinical": (N, P)}."""
        image_features = self.image_model(inputs["image"], return_features=True)
        clinical_features = self.clinical_model(inputs["clinical"],
                                                return_features=True)
        out = self.output_head(
            torch.cat([image_features, clinical_features], dim=1))
        if self.blend:
            out = torch.stack([
                out,
                self.image_output_head(image_features),
                self.clinical_output_head(clinical_features),
            ])
        return out
