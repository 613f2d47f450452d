"""Plain single-device attention over the repo's [B, S, H, D] layout
(``mpi_pytorch_tpu/ops/ring_attention.py``: ``full_attention``).

``full_attention`` is the plain version of both attention kernels
(``ops/fused_attention_small.py``, ``ops/flash_attention.py``) and the
``attn_impl="full"`` path of the vit family. Ring attention itself — the
sequence-parallel strategy that rotates k/v blocks around a mesh axis —
waits for the sequence-parallel slice of the port: this module holds only
the single-device function and its operand check.
"""

from __future__ import annotations

import torch


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """softmax((q·D^-0.5)·kᵀ)·v over [B, S, H, D] inputs: q scaled in f32,
    f32 scores, softmax, f32 AV, cast to q's dtype. ``causal`` masks key
    positions past each query's (aligned at the last query)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Self-attention operands: q, k and v of one [B, S, H, D] shape."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"attention takes q, k, v of one [B, S, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
