"""Grad-CAM attention maps, 3D or 2D (counterpart of the JAX package's
ops/gradcam.py:29-90).

* the target is the last convolution of the image encoder (a DenseNet's
  last dense layer's 3x3x3 convolution, TinyCNN's conv5 before its
  BatchNorm): the model's ``capture_gradcam`` path returns it as ``act``,
  a tensor of the forward's graph, so ``torch.autograd.grad(logit, act)``
  is what the JAX package's zero probe gives. SE-ResNet50 and R3D-18 have
  no such path in the JAX package; theirs raises ``ConfigurationError``;
* per class c: the gradient of the logit [0, c] (blend: [0, 0, c], the
  multimodal head) with respect to ``act``, pooled per channel over batch
  and space; a fresh copy of ``act`` weighted by it (the reference scales
  its activation buffer in place, which leaks class 0's weights into
  class 1's map; the JAX package implements the evident intent, and so
  does this); the mean over channels, all in ``act``'s dtype (bfloat16
  under ``TPU.compute_dtype: bfloat16``, gradcam.py:62-84); then, widened
  to float32, the minimum shifted to 0 and the result divided by
  max(max, 1e-12), and a linear resize (trilinear, or bilinear for a 2D
  model) to the input's spatial shape (the JAX package normalises and
  resizes in ``act``'s dtype);
* batch size 1 only.

The forward is one eval-mode call with autograd on, so every DenseNet
bottleneck runs through the fused op as in any other forward; each class
pulls one gradient through the layers after ``act`` only.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def resize_trilinear(volume, size):
    """(d, h, w) or (h, w) -> ``size`` by n-linear interpolation with
    half-pixel centres (``jax.image.resize(method="trilinear")``, which is
    linear in any number of dimensions, when upsampling)."""
    mode = {2: "bilinear", 3: "trilinear"}[volume.dim()]
    return F.interpolate(volume[None, None], size=tuple(size), mode=mode,
                         align_corners=False)[0, 0]


def attention_maps(model, inputs, num_classes: int, blend: bool = False):
    """Per-class attention maps of a batch-1 input.

    Args:
      model: an eval-mode model with a ``capture_gradcam`` path.
      inputs: what the model takes, batch size 1 (a dict with ``"image"``
        (1, *spatial, C), or the image tensor itself), already
        transformed.
      num_classes: C.
      blend: whether the output is the (K, N, C) head stack.

    Returns (C, *spatial) float32 maps on the input's device.
    """
    image = inputs["image"] if isinstance(inputs, dict) else inputs
    if image.shape[0] != 1:
        raise AssertionError(
            "Batch dimension found in attention map - Must use batch size 1 "
            "when computing attention maps"
        )
    spatial = image.shape[1:-1]
    with torch.enable_grad():
        out, act = model(inputs, capture_gradcam=True)
        maps = []
        for cls in range(num_classes):
            logit = out[0, 0, cls] if blend else out[0, cls]
            (grads,) = torch.autograd.grad(
                logit, act, retain_graph=cls < num_classes - 1)
            with torch.no_grad():
                # act: (1, channels, *spatial')
                spatial_axes = tuple(range(2, act.dim()))
                pooled = grads.mean(dim=(0,) + spatial_axes)
                heatmap = (act * pooled.view((1, -1) + (1,) * len(
                    spatial_axes))).mean(1)[0].float()
                heatmap = heatmap - heatmap.min()
                heatmap = heatmap / torch.clamp(heatmap.max(), min=1e-12)
                maps.append(resize_trilinear(heatmap, spatial))
    return torch.stack(maps)
