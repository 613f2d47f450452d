"""Shared building blocks of the port's models (``mpi_pytorch_tpu/models/
common.py``): batchnorm, the fused stem module, convolutions, pools, dense
layers and layer norm.

Activations are NCHW tensors in channels_last memory end to end, so a
conv output viewed with ``permute(0, 2, 3, 1)`` is NHWC memory with no
copy — the layout the fused stem kernels read. Parameters are f32 masters:
each convolution and dense layer casts its weights to the input's
(compute) dtype per call, as flax's ``dtype=`` does, so a bf16 model rounds
where the JAX model rounds. Normalization parameters and running
statistics stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.ops.fused_stem import stem_affine_relu_pool

# torch BatchNorm defaults (the JAX package's BN_EPS / BN_MOMENTUM = 1 − 0.1).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _channel_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 batch mean and ``E[x²] − mean²`` per channel of an NCHW tensor,
    with autograd attached (the gradient through the statistics reaches
    ``x``, as it does in JAX)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    return mean, xf.square().mean(dim=(0, 2, 3)) - mean.square()


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with torch's defaults and state names (``weight``,
    ``bias``, ``running_mean``, ``running_var``) and flax's training
    arithmetic.

    Eval mode normalizes with the running statistics (``nn.BatchNorm2d``;
    f32 parameters work on a bf16 input). Training mode follows flax
    ``BatchNorm`` (``_compute_stats``/``_normalize``): the batch mean and
    fast variance ``E[x²] − mean²`` in f32, clipped at 0; the output
    ``(x − mean)·(rsqrt(var+ε)·γ) + β`` in f32, cast to the input's dtype;
    and the running statistics updated with momentum 0.1 and the BIASED
    batch variance (``nn.BatchNorm2d`` would use the unbiased one).
    ``num_batches_tracked`` stays as torch made it: the momentum is fixed."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``ra = (1 − m)·ra + m·stat`` with the batch mean and biased
        variance (flax's ``momentum·ra + (1 − momentum)·stat``)."""
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean, var = _channel_stats(x)
        var = var.clamp_min(0.0)
        self.update_running_stats(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - _per_channel(mean)) * _per_channel(mul) + _per_channel(self.bias.float())
        return y.to(x.dtype)


def batch_norm(num_features: int, eps: float = BN_EPS) -> BatchNorm:
    """The port's batchnorm (see :class:`BatchNorm`)."""
    return BatchNorm(num_features, eps=eps)


class FusedStemBNReluPool(BatchNorm):
    """BatchNorm + ReLU + 3×3/s2/p1 max-pool as ONE op — the resnet stem
    tail (torchvision ``bn1``/``relu``/``maxpool``) through the fused stem
    kernels (``ops/fused_stem.py``).

    Same parameters and buffers as ``batch_norm``, so state dicts move
    freely between the fused and unfused stem. It folds
    ``a = γ·rsqrt(var+ε)``, ``b = β − μ·a`` in f32 — from the running
    statistics in eval mode, from the batch in training mode — hands the
    conv output to the kernels as NHWC and returns channels_last NCHW in
    the input's dtype.

    Training mirrors the JAX module: f32 batch mean and ``E[y²] − mean²``,
    NOT clipped (the fused module does not clip), the biased running
    update, and ``a``/``b`` folded with autograd attached, so the gradient
    through the statistics reaches ``y`` beside the kernel's own ``dy``."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = _channel_stats(y)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        a = self.weight.float() * torch.rsqrt(var + self.eps)
        b = self.bias.float() - mean * a
        out = stem_affine_relu_pool(y.permute(0, 2, 3, 1), a, b)
        return out.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """A convolution whose f32 master weight is cast to the input's dtype
    per call (a no-op once ``prepare_for_inference`` has cast it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool with −inf padding (torch's, and flax's reduce_window)."""
    return F.max_pool2d(x, kernel_size=window, stride=stride, padding=padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C] mean over the spatial dims."""
    return x.mean(dim=(2, 3))


class Dense(nn.Linear):
    """flax ``Dense``: weight ``[out, in]`` (K-major) and bias as f32
    masters, the matmul in the input's (compute) dtype — both cast per call
    (a no-op once ``prepare_for_inference`` has cast them). As the head, the
    predict step recasts its logits to f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


# flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with torch's state names (``weight``,
    ``bias``, f32) and flax ``LayerNorm``'s arithmetic: ε = 1e-6, the f32
    mean and fast variance ``E[x²] − mean²`` clipped at 0, then
    ``(x − mean)·(rsqrt(var + ε)·γ) + β`` in f32, cast to the input's
    dtype."""

    def __init__(self, num_features: int, eps: float = LN_EPS):
        super().__init__(num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)
