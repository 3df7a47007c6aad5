"""PyTorch/CUDA port of the JAX/TPU framework for one NVIDIA H100.

The JAX package beside it in this repository is the reference this
package is held against; this package imports nothing from it and nothing
of JAX. Module names mirror the JAX package's, so each module's counterpart
is easy to find.
Activations are channels-last, as in the JAX package: public image inputs are
``(N, D, H, W, C)``, and inside the networks they are ``(N, C, D, H, W)``
tensors in ``torch.channels_last_3d`` memory format.

Ported so far: the survival and classification training runs end to end
through ``python -m mmnn_sts_torch`` (``cli``): the cohort build
(``data/``, ``pipeline``), the training augmentation (``ops/augment``),
the device-resident loader, the superstep (``train/steps``: train-mode
BatchNorm, dropout, the blended Cox loss, SGD-nesterov with OneCycle), the
epoch loop with validation, checkpoints and blend updates (``train/loop``,
``train/checkpoint``); inference with bootstrap intervals and Grad-CAM
(``infer/run``); the LR range test (``train/lr_finder``); and the serving
path (export + HTTP server). Every image model the JAX registry builds
(``models/registry``: the DenseNets, TinyCNN, SE-ResNet50, R3D-18) and the
clinical MLP, with ``TPU.remat`` for the DenseNets, each in float32 or
bfloat16 (``TPU.compute_dtype``). The DenseNet bottleneck
(BN + ReLU + 1x1x1 conv) runs under autograd through two hand-written CUDA
kernels, one per dtype: ``kernels/csrc/fused_bn_relu_matmul.cu`` (float32,
CUDA cores) and ``kernels/csrc/fused_bn_relu_matmul_bf16.cu`` (bfloat16,
wgmma on the tensor cores). On a CPU tensor the op takes its plain PyTorch
version, which the CPU tests hold against the JAX package; the ``cuda``
tests and ``chip_smoke.py`` hold each kernel against that version on the
card.
"""
