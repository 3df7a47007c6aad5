"""PyTorch/CUDA port of the JAX/TPU framework for one NVIDIA H100.

The JAX package beside it in this repository is the reference this
package is held against; this package imports nothing from it and nothing
of JAX. Module names mirror the JAX package's, so each module's counterpart
is easy to find.
Activations are channels-last, as in the JAX package: public image inputs are
``(N, D, H, W, C)``, and inside the networks they are ``(N, C, D, H, W)``
tensors in ``torch.channels_last_3d`` memory format.

Ported so far: the serving path (export + HTTP server) of the DenseNet121 /
TinyDenseNet multimodal models and the clinical MLP, and their survival
training step (``train/steps.survival_train_superstep``: train-mode
BatchNorm, dropout, the blended Cox loss, SGD-nesterov with OneCycle), with
the DenseNet bottleneck (BN + ReLU + 1x1x1 conv) as a hand-written CUDA
kernel (``kernels/csrc/fused_bn_relu_matmul.cu``) under autograd.
"""
