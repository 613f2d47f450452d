"""Fused resnet stem tail: ``max_pool3x3s2p1(relu(y·a + b))`` in one pass,
differentiable through a window-index backward.

Counterpart of ``mpi_pytorch_tpu/ops/fused_stem.py``. ``a``/``b`` are the
folded batchnorm affine (``a = γ·rsqrt(var+ε)``, ``b = β − μ·a``, f32);
the affine, relu and max-pool run in f32 and the output keeps ``y``'s
dtype. Three CUDA kernels in ``csrc/fused_stem.cu`` carry it:

- the eval forward (TPU ``_primal_kernel``), when no input needs a
  gradient;
- the training forward (TPU ``_fwd_kernel`` with ``want_idx``), which also
  writes the first-match window index ``k = dh·3 + dw`` (int8);
- the backward (TPU ``_bwd_kernel``): routes the pooled gradient through
  ``k`` to the ≤4 covering inputs, masks it with ``pooled > 0``, and gives
  ``dy = du·a``, ``da = Σ du·y``, ``db = Σ du`` — one pass, each thread
  writing the 2×2 inputs of one window (a quad gather), ``da`` and ``db``
  folded in fixed order by the last block to finish.

The last two pair up in :class:`_StemPool`, the ``torch.autograd.Function``
that mirrors the JAX ``custom_vjp`` ``_stem_pool_t``.

``y`` is ``[B, H, W, C]`` with H, W even, in NHWC memory — a channels_last
conv output viewed with ``permute(0, 2, 3, 1)``, no copy. On a CUDA tensor
each wrapper launches its kernel (bf16 or f32, C a multiple of 8,
contiguous) or raises; on a CPU tensor it runs its plain PyTorch version
(``*_reference``), so the CPU tests exercise the port's own backward
formula.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.ops import _build

# Launches of each CUDA kernel (the plain versions never count): the eval
# forward, the training forward with the window index, the backward.
counter = _build.LaunchCounter("fused_stem.counter")
argmax_counter = _build.LaunchCounter("fused_stem.argmax_counter")
backward_counter = _build.LaunchCounter("fused_stem.backward_counter")


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


def _check_kernel_operands(y: torch.Tensor, affine: dict[str, torch.Tensor]) -> None:
    if y.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"fused stem kernel takes bf16 or f32 y, got {y.dtype}")
    if y.shape[-1] % 8:
        raise ValueError(f"fused stem kernel needs C % 8 == 0, got C={y.shape[-1]}")
    if not y.is_contiguous():
        raise ValueError(
            "fused stem kernel needs y in NHWC memory: pass a channels_last "
            "conv output viewed with permute(0, 2, 3, 1)"
        )
    for name, t in affine.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != y.device:
            raise ValueError(f"fused stem kernel needs {name} f32 contiguous on {y.device}")
    if y.data_ptr() % 16 or any(t.data_ptr() % 16 for t in affine.values()):
        raise ValueError("fused stem kernel needs 16-byte aligned operands")


def _affine_relu(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # A multiply then an add, each rounded: the kernels that return the
    # window index round the same way, so they agree bit for bit.
    return torch.relu(y.float() * a.float() + b.float())


def stem_affine_relu_pool_reference(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the eval forward: f32 affine + relu,
    3×3/s2/p1 max-pool (padding counts as −inf; NaN propagates), cast back
    to ``y.dtype``."""
    _check_shapes(y, a, b)
    z = _affine_relu(y, a, b)
    pooled = F.max_pool2d(z.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
    return pooled.permute(0, 2, 3, 1).to(y.dtype)


def _windows(t: torch.Tensor, h2: int, w2: int):
    """(k, view) for the 9 window offsets k = dh·3 + dw of a [B, H+2, W+2,
    C] padded tensor: view[:, oh, ow] is the padded element (2·oh + dh,
    2·ow + dw), i.e. input (2·oh − 1 + dh, 2·ow − 1 + dw)."""
    for k in range(9):
        dh, dw = divmod(k, 3)
        yield k, t[:, dh : dh + 2 * h2 : 2, dw : dw + 2 * w2 : 2, :]


def stem_pool_argmax_reference(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the training forward: (pooled in
    ``y.dtype``, k int8), both ``[B, H/2, W/2, C]``. k is the first window
    offset in row-major (dh, dw) order attaining the max (a strict ``>``
    fold), padding −inf; NaN propagates into the max as in the eval
    forward."""
    _check_shapes(y, a, b)
    bsz, h, w, c = y.shape
    zpad = F.pad(_affine_relu(y, a, b), (0, 0, 1, 1, 1, 1), value=float("-inf"))
    m = torch.full((bsz, h // 2, w // 2, c), float("-inf"), device=y.device)
    k = torch.zeros((bsz, h // 2, w // 2, c), dtype=torch.int8, device=y.device)
    for kk, cand in _windows(zpad, h // 2, w // 2):
        k.masked_fill_(cand > m, kk)
        m = torch.maximum(m, cand)
    return m.to(y.dtype), k


def stem_pool_backward_reference(
    g: torch.Tensor, k: torch.Tensor, pooled: torch.Tensor, y: torch.Tensor, a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: (dy in ``y.dtype``, da f32
    [C], db f32 [C]). Each input sums the masked gradients of the windows
    whose index names it, in the order of the kernel (and of the TPU
    kernel's phase gather): window offset 8 down to 0."""
    bsz, h, w, c = y.shape
    h2, w2 = h // 2, w // 2
    gm = torch.where(pooled.float() > 0, g.float(), 0.0)
    du = torch.zeros((bsz, h + 2, w + 2, c), device=y.device)
    views = dict(_windows(du, h2, w2))
    for kk in reversed(range(9)):
        views[kk] += torch.where(k == kk, gm, 0.0)
    du = du[:, 1 : h + 1, 1 : w + 1, :]
    dy = (du * a.float()).to(y.dtype)
    return dy, (du * y.float()).sum(dim=(0, 1, 2)), du.sum(dim=(0, 1, 2))


def stem_pool_argmax(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, k) of the training forward: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check_shapes(y, a, b)
    if _build.on_cpu(y, "fused stem"):
        return stem_pool_argmax_reference(y, a, b)
    _check_kernel_operands(y, {"a": a, "b": b})
    bsz, h, w, c = y.shape
    out = torch.empty((bsz, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    idx = torch.empty((bsz, h // 2, w // 2, c), dtype=torch.int8, device=y.device)
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        code = lib.mpt_stem_pool_argmax(
            y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), idx.data_ptr(),
            bsz, h, w, c, _build.DTYPE_CODE[y.dtype], _build.stream(y.device),
        )
    _build.check(code, "stem_pool_argmax")
    argmax_counter.add()
    return out, idx


def stem_pool_backward(
    g: torch.Tensor, k: torch.Tensor, pooled: torch.Tensor, y: torch.Tensor, a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy, da, db) of the backward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. da and db are deterministic: two calls
    on the same inputs give the same bits."""
    if _build.on_cpu(y, "fused stem"):
        return stem_pool_backward_reference(g, k, pooled, y, a)
    bsz, h, w, c = y.shape
    small = (bsz, h // 2, w // 2, c)
    for name, t in (("g", g), ("pooled", pooled), ("k", k)):
        if tuple(t.shape) != small or t.device != y.device or not t.is_contiguous():
            raise ValueError(f"stem backward needs {name} {small} contiguous on {y.device}")
    if g.dtype != y.dtype or pooled.dtype != y.dtype or k.dtype != torch.int8:
        raise TypeError(
            f"stem backward takes g and pooled in y's dtype {y.dtype} and int8 k, "
            f"got {g.dtype}, {pooled.dtype}, {k.dtype}"
        )
    _check_kernel_operands(y, {"a": a})
    if c > 256 or 256 % (c // 8):
        raise ValueError(f"stem backward kernel needs C <= 256 with 256 % (C/8) == 0, got C={c}")
    if any(t.data_ptr() % 16 for t in (g, pooled, k)):
        raise ValueError("fused stem kernel needs 16-byte aligned operands")
    lib = _build.load_library()
    n_part = lib.mpt_stem_bwd_parts(bsz, h, w, c)
    if n_part < 0:
        raise ValueError(f"stem backward: y {tuple(y.shape)} is too large for one grid")
    dy = torch.empty_like(y)
    dadb = torch.empty((2, c), dtype=torch.float32, device=y.device)
    # The kernel's scratch: f32 [n_part, 2, C] block sums, then its u32 ticket.
    part = torch.empty(n_part * 2 * c + 1, dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        code = lib.mpt_stem_pool_bwd(
            g.data_ptr(), k.data_ptr(), pooled.data_ptr(), y.data_ptr(), a.data_ptr(),
            dy.data_ptr(), dadb.data_ptr(), part.data_ptr(),
            bsz, h, w, c, _build.DTYPE_CODE[y.dtype], _build.stream(y.device),
        )
    _build.check(code, "stem_pool_backward")
    backward_counter.add()
    return dy, dadb[0], dadb[1]


class _StemPool(torch.autograd.Function):
    """The differentiable stem tail: the training forward saves ``(y, a,
    pooled, k)``, the backward routes the gradient through ``k``. ``dy``
    comes back in ``y.dtype``, ``da``/``db`` in f32."""

    @staticmethod
    def forward(ctx, y, a, b):
        pooled, k = stem_pool_argmax(y, a, b)
        ctx.save_for_backward(y, a, pooled, k)
        ctx.mark_non_differentiable(k)
        return pooled

    @staticmethod
    def backward(ctx, g):
        y, a, pooled, k = ctx.saved_tensors
        dy, da, db = stem_pool_backward(g.to(y.dtype).contiguous(), k, pooled, y, a)
        return dy, da, db


def stem_affine_relu_pool(
    y: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``max_pool3x3s2p1(relu(y·a + b))`` → ``[B, H/2, W/2, C]`` in
    ``y.dtype``. With no gradient to take, the eval forward (its kernel for
    a CUDA tensor, the plain version for a CPU one); otherwise
    :class:`_StemPool`, the training forward and the index backward."""
    _check_shapes(y, a, b)
    if torch.is_grad_enabled() and (y.requires_grad or a.requires_grad or b.requires_grad):
        return _StemPool.apply(y, a, b)
    if _build.on_cpu(y, "fused stem"):
        return stem_affine_relu_pool_reference(y, a, b)
    _check_kernel_operands(y, {"a": a, "b": b})
    bsz, h, w, c = y.shape
    out = torch.empty((bsz, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        code = lib.mpt_stem_pool_fwd(
            y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, h, w, c, _build.DTYPE_CODE[y.dtype], _build.stream(y.device),
        )
    _build.check(code, "stem_affine_relu_pool")
    counter.add()
    return out
