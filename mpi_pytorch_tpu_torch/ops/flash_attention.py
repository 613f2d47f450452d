"""Flash attention: block-tiled online-softmax attention that never holds an
S×S tensor, with a blocked backward from the saved logsumexp.

Counterpart of ``mpi_pytorch_tpu/ops/flash_attention.py``. The same
function as ``full_attention`` over [B, S, H, D] inputs.

- The forward is a CUDA kernel in ``csrc/flash_attention.cu`` (TPU
  ``_attn_fwd_kernel``): one CTA per (batch·head, q-block) runs the online
  recurrence over the k-blocks and writes the output and the f32
  logsumexp of every row. Two routes, by
  :func:`_build.attention_route`: bf16 (any D % 4 == 0 up to 128) goes to
  the tensor-core kernel (wgmma, p·v through a p split into three bf16
  terms that keeps it f32-exact; a D that is not a multiple of 16 runs
  zero-padded to the next one, its rows copied in 16- or 8-byte pieces or
  element by element as their alignment allows); f32 (any D % 4 == 0 up to
  128) to the f32 tensor-core kernel (q·scale, k, v and p split into three
  bf16 terms, each product six exact term-pair products). Both choose
  their own tiles for Hopper (128 queries, k/v blocks of 64).
- The backward is the JAX ``_bwd_blocked`` in torch, block for block: per
  k-block, the probabilities recomputed from the saved logsumexp, then dv,
  dp, ds, dq (accumulated) and dk — O(S·block) memory, never S×S. The JAX
  side runs it as an XLA ``lax.scan``, not a Pallas kernel, so it has no
  kernel here either.

Block sizes follow the JAX wrapper: ``min(block, max(8, S))``, 128 by
default; they set the blocked backward's tiles (the forward kernels check
them but tile for Hopper). Padded keys get −1e30 and a fully masked row's
sum counts as 1. On a CUDA tensor the forward launches its route's kernel
(f32 or bf16, D % 4 == 0, D ≤ 128, blocks ≤ 128) or raises; on a CPU
tensor it runs its plain version, :func:`flash_forward_reference`.
"""

from __future__ import annotations

import torch

from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops.ring_attention import check_qkv, full_attention

# Launches of the forward kernel of each route (the plain version never
# counts): the bf16 tensor-core kernel at D % 16 == 0 and zero-padded at
# other D, and the f32 tensor-core kernel.
tc_counter = _build.LaunchCounter()
tc_pad_counter = _build.LaunchCounter()
tc_f32_counter = _build.LaunchCounter()

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
# What one CTA of the kernel holds: blocks and head dims up to 128.
MAX_BLOCK = 128
MAX_HEAD_DIM = 128


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the forward: (``full_attention``, the
    f32 logsumexp [B, H, S] of each row's scores (q·scale)·kᵀ, −inf past
    the diagonal when ``causal``)."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * q.shape[-1] ** -0.5, k.float())
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return full_attention(q, k, v, causal=causal), torch.logsumexp(scores, -1)


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, H, D] in q's dtype, lse f32 [B, H, S]): for CUDA tensors
    the tensor-core kernel of :func:`_build.attention_route` (bf16 or f32,
    any D % 4 == 0 up to 128; its own tiles: ``block_q``/``block_k`` are
    checked but do not shape it); the plain version for CPU tensors."""
    check_qkv(q, k, v)
    if _build.on_cpu(q, "flash_attention"):
        return flash_forward_reference(q, k, v, causal)
    bsz, s, h, d = q.shape
    sb, ss, sh = _build.attention_layout(q, k, v, "flash_attention", MAX_HEAD_DIM)
    if not (1 <= block_q <= MAX_BLOCK and 1 <= block_k <= MAX_BLOCK):
        raise ValueError(
            f"flash_attention kernel takes blocks of 1..{MAX_BLOCK}, got {block_q}, {block_k}"
        )
    out = torch.empty((bsz, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bsz, h, s), dtype=torch.float32, device=q.device)
    route = _build.attention_route(q.dtype, d)
    if route == "tensor_core_f32":
        _build.require_16b_rows(q, k, v, "flash_attention")
    lib = _build.load_library()
    entry = lib.mpt_flash_fwd_tc if route == "tensor_core" else lib.mpt_flash_fwd_tc_f32
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), sb, ss,
                   sh, bsz, s, h, d, d**-0.5, int(causal), _build.stream(q.device))
    _build.check(rc, "flash_attention forward")
    if route == "tensor_core_f32":
        tc_f32_counter.add()
    else:
        (tc_pad_counter if d % 16 else tc_counter).add()
    return out, lse


def flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = False,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in their operands' dtypes from the saved ``lse`` [B, H,
    S]: the JAX ``_bwd_blocked`` in plain torch products, one k-block at a
    time. Keys past S are sliced off where the JAX loop pads and masks
    them: their probabilities are exact zeros either way."""
    s, d = q.shape[1], q.shape[-1]
    scale = d**-0.5
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, D]
    qs = qf * scale
    # Δ_i = Σ_d dOut·Out, the softmax Jacobian's diagonal term.
    delta = (dof * out.float().transpose(1, 2)).sum(dim=-1, keepdim=True)
    lse_r = lse[..., None]
    q_pos = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for lo in range(0, s, block_k):
        hi = min(s, lo + block_k)
        k_blk, v_blk = kf[:, :, lo:hi], vf[:, :, lo:hi]
        p = torch.exp(qs @ k_blk.transpose(-1, -2) - lse_r)  # [B, H, S, bk]
        if causal:
            k_pos = torch.arange(lo, hi, device=q.device)[None, :]
            p = torch.where(k_pos <= q_pos, p, 0.0)
        dv[:, :, lo:hi] = p.transpose(-1, -2) @ dof
        ds = p * (dof @ v_blk.transpose(-1, -2) - delta)
        dq = dq + (ds @ k_blk) * scale
        dk[:, :, lo:hi] = (ds.transpose(-1, -2) @ qf) * scale
    return tuple(g.transpose(1, 2).to(t.dtype) for g, t in ((dq, q), (dk, k), (dv, v)))


class _Flash(torch.autograd.Function):
    """The differentiable flash attention: the forward kernel saves (q, k,
    v, out, lse); the backward is :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_forward(q, k, v, causal, block_q, block_k)
        ctx.causal, ctx.block_k = causal, block_k
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do, ctx.causal, ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash attention over [B, S, H, D] inputs, the same function as
    ``full_attention``; blocks ``min(block, max(8, S))`` as the JAX
    wrapper cuts them. With a gradient to take, :class:`_Flash`."""
    check_qkv(q, k, v)
    s = q.shape[1]
    bq, bk = min(block_q, max(8, s)), min(block_k, max(8, s))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, bq, bk)
    return flash_forward(q, k, v, causal, bq, bk)[0]
