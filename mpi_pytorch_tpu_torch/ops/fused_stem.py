"""Fused resnet stem tail: ``max_pool3x3s2p1(relu(y·a + b))`` in one pass.

Counterpart of ``mpi_pytorch_tpu/ops/fused_stem.py``. ``a``/``b`` are the
folded batchnorm affine (``a = γ·rsqrt(var+ε)``, ``b = β − μ·a``, f32);
the affine, relu and max-pool run in f32 and the output keeps ``y``'s
dtype. This slice ports the forward (the eval/serve primal,
``_primal_kernel``): the training forward with the window argmax and the
index backward come with the training slice.

``y`` is ``[B, H, W, C]`` with H, W even, in NHWC memory — a channels_last
conv output viewed with ``permute(0, 2, 3, 1)``, no copy. On a CUDA
tensor :func:`stem_affine_relu_pool` launches the kernel in
``csrc/fused_stem.cu`` (bf16 or f32, C a multiple of 8, contiguous) or
raises; on a CPU tensor it runs :func:`stem_affine_relu_pool_reference`,
the plain PyTorch version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.ops import _build

# Launches of the CUDA kernel (the plain version never counts).
counter = _build.LaunchCounter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    if y.dim() != 4:
        raise ValueError(f"fused stem takes y [B, H, W, C], got shape {tuple(y.shape)}")
    _, h, w, c = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused stem needs even spatial dims, got {h}x{w}")
    if tuple(a.shape) != (c,) or tuple(b.shape) != (c,):
        raise ValueError(
            f"affine shape mismatch: {tuple(a.shape)}/{tuple(b.shape)} vs C={c}"
        )


def stem_affine_relu_pool_reference(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: f32 affine + relu, 3×3/s2/p1 max-pool
    (padding counts as −inf; NaN propagates), cast back to ``y.dtype``."""
    _check_shapes(y, a, b)
    z = torch.relu(y.float() * a.float() + b.float())
    pooled = F.max_pool2d(z.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
    return pooled.permute(0, 2, 3, 1).to(y.dtype)


def stem_affine_relu_pool(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``max_pool3x3s2p1(relu(y·a + b))`` → ``[B, H/2, W/2, C]`` in
    ``y.dtype``. The CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    _check_shapes(y, a, b)
    if y.device.type == "cpu":
        return stem_affine_relu_pool_reference(y, a, b)
    if y.device.type != "cuda":
        raise ValueError(f"fused stem runs on cuda or cpu, got {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "the fused stem's backward (window argmax + index backward, the "
            "TPU kernels _fwd_kernel/_bwd_kernel) is ported with the training "
            "slice; run the forward under torch.no_grad()"
        )
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused stem kernel takes bf16 or f32 y, got {y.dtype}")
    bsz, h, w, c = y.shape
    if c % 8:
        raise ValueError(f"fused stem kernel needs C % 8 == 0, got C={c}")
    if not y.is_contiguous():
        raise ValueError(
            "fused stem kernel needs y in NHWC memory: pass a channels_last "
            "conv output viewed with permute(0, 2, 3, 1)"
        )
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != y.device:
            raise ValueError(f"fused stem kernel needs {name} f32 contiguous on {y.device}")
    if y.data_ptr() % 16 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("fused stem kernel needs 16-byte aligned y, a and b")
    out = torch.empty((bsz, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.mpt_stem_pool_fwd(
            y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, h, w, c, _DTYPE_CODE[y.dtype], stream,
        )
    _build.check(code, "stem_affine_relu_pool")
    counter.add()
    return out
