"""Shared building blocks of the port's CNNs (``mpi_pytorch_tpu/models/
common.py``): eval-mode batchnorm, the fused stem module, pools and the
classifier head.

Activations are NCHW tensors in channels_last memory end to end, so a
conv output viewed with ``permute(0, 2, 3, 1)`` is NHWC memory with no
copy — the layout the fused stem kernel reads. Convolutions run in the
compute dtype; batchnorm parameters and running statistics stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.ops.fused_stem import stem_affine_relu_pool

# torch BatchNorm defaults (the JAX package's BN_EPS / BN_MOMENTUM = 1 − 0.1).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batch_norm(num_features: int, eps: float = BN_EPS) -> nn.BatchNorm2d:
    """BatchNorm matching torch defaults. The serving path runs it in eval
    mode (running statistics); f32 parameters work on a bf16 input."""
    return nn.BatchNorm2d(num_features, eps=eps, momentum=BN_MOMENTUM)


class FusedStemBNReluPool(nn.BatchNorm2d):
    """BatchNorm + ReLU + 3×3/s2/p1 max-pool as ONE op — the resnet stem
    tail (torchvision ``bn1``/``relu``/``maxpool``) through the fused stem
    kernel (``ops/fused_stem.py``).

    Same parameters and buffers as ``batch_norm`` (it IS a BatchNorm2d),
    so state dicts move freely between the fused and unfused stem. Eval
    only in this slice: it folds ``a = γ·rsqrt(var+ε)``, ``b = β − μ·a`` in
    f32 from the running statistics, as the JAX module does, hands the
    conv output to the kernel as NHWC and returns channels_last NCHW in
    the input's dtype."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "the fused stem's training mode (batch statistics + index "
                "backward) is ported with the training slice; call .eval()"
            )
        a = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        b = self.bias.float() - self.running_mean.float() * a
        out = stem_affine_relu_pool(y.permute(0, 2, 3, 1), a, b)
        return out.permute(0, 3, 1, 2)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool with −inf padding (torch's, and flax's reduce_window)."""
    return F.max_pool2d(x, kernel_size=window, stride=stride, padding=padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C] mean over the spatial dims."""
    return x.mean(dim=(2, 3))


class Classifier(nn.Linear):
    """Final dense head, weight ``[num_classes, in]`` (K-major) and bias in
    f32. The matmul runs in the input's (compute) dtype, as the JAX head
    does; the predict step recasts the logits to f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
