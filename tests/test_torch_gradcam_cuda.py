"""Grad-CAM (``ops/gradcam.attention_maps``) with the fused bottleneck's
CUDA kernel against the same maps with the kernel's plain version patched
in, on the card.

A narrow TinyDenseNet multimodal blend model (blocks 6, 12, 4; growth 8,
16 initial features, bottleneck width 16) at 32^3 x 2ch with seeded
weights, cuDNN's TF32 off: the one Grad-CAM forward launches the kernel
once a dense layer (22 times), and the maps agree within 1e-3. Skips
without a card; it imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_gradcam_cuda.py -m cuda
--noconftest``.
"""

from unittest import mock

import pytest
import torch

from mmnn_sts_torch.models.densenet import tiny_densenet
from mmnn_sts_torch.models.multimodal import MultiModalModel
from mmnn_sts_torch.ops import fused_dense as fd
from mmnn_sts_torch.ops.gradcam import attention_maps

TINY = dict(growth_rate=8, init_features=16, bn_size=2, feature_channels=4,
            in_channels=2)


@pytest.mark.cuda
def test_attention_maps_with_the_kernel_match_the_plain_op():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused kernel runs only there)")
    torch.manual_seed(0)
    model = MultiModalModel(
        tiny_densenet(**TINY, out_channels=None), 11, num_classes=2,
        num_features=4, blend=True).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs = {"image": torch.randn(1, 32, 32, 32, 2, device="cuda",
                                   generator=g),
              "clinical": torch.randn(1, 11, device="cuda", generator=g)}
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = fd.fused_bn_relu_matmul.launches
        got = attention_maps(model, inputs, num_classes=2, blend=True)
        torch.cuda.synchronize()
        launched = fd.fused_bn_relu_matmul.launches - before
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            want = attention_maps(model, inputs, num_classes=2, blend=True)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    assert launched == sum(model.image_model.block_config) == 22
    assert got.shape == want.shape == (2, 32, 32, 32)
    assert (got - want).abs().max().item() <= 1e-3
    assert want.max().item() > 0.5
