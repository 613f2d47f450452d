"""Fused tiny-S attention: scores, softmax and AV in one pass per (batch,
head), with a recompute backward.

Counterpart of ``mpi_pytorch_tpu/ops/fused_attention_small.py``. The same
function as ``full_attention`` over [B, S, H, D] inputs; the envelope is
the JAX one: S ≤ 128 and D ≤ 128 go through the kernels, anything outside
it is ``full_attention`` (the function's definition, not a fallback on
failure). CUDA kernels in ``csrc/fused_attention_small.cu`` carry it, three
for the forward and two for the backward:

- the forward (TPU ``_fwd_kernel``): the whole row set of one (batch,
  head) on one CTA, a full-row max/exp/sum, AV, then ÷ l. By
  :func:`_route`: the training forward in bf16 with D % 16 == 0 runs the
  tensor-core kernel (wgmma, p·v through a split-bf16 p that keeps it
  f32-exact; persistent CTAs with the next head's q, k, v in flight);
  every f32 forward (any D % 4 == 0, training and inference) the f32
  tensor-core kernel (q·scale, k, v and p split into three bf16 terms,
  each product six exact term-pair products); bf16 with any other D
  (training too) and every bf16 inference call (serving, validation) the
  f32 FFMA kernel,
  whose sums run in the plain version's order (see :func:`_route`): per
  warp 16 whole query rows in 8-row register tiles, the softmax in
  registers, persistent CTAs reading each head straight into f32 tiles;
- the backward (TPU ``_bwd_kernel``): recomputes p (normalized before
  use), then Δ, ds = p·(do·vᵀ − Δ), dq = ds·k·scale, dk = dsᵀ·q·scale,
  dv = pᵀ·do — each (batch, head) writes its own gradients, so no
  atomics. By :func:`_build.attention_route`: bf16 (any D % 4 == 0) runs
  the tensor-core kernel (p and ds split into three bf16 terms, Δ = Σ
  p·dp; a D that is not a multiple of 16 zero-padded to the next one, its
  rows copied in 16- or 8-byte pieces or element by element as their
  alignment allows); f32 (any D % 4 == 0) the f32 tensor-core kernel
  (q·scale, k, v, do, p and ds split into three bf16 terms, each product
  six exact term-pair products, Δ = Σ p·dp). The backward has no
  inference caller, so every backward takes the rule as it is.

They pair up in :class:`_FusedSmall`, whose residuals are q, k and v only,
as the JAX ``_attn_grouped_fwd`` saves. q, k and v are read as the
projections give them (strided [B, S, H, D] views); the JAX wrapper's
transpose to [B·H, S, D], its bh-grouping and its sublane padding of S are
TPU layout and stay behind. On a CUDA tensor each wrapper launches its
route's kernel (f32 or bf16, D % 4 == 0) or raises; on a CPU tensor it
runs its plain version: ``full_attention`` forward,
:func:`attention_small_backward_reference` backward.
"""

from __future__ import annotations

import torch

from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops.ring_attention import check_qkv, full_attention

# Launches of each CUDA kernel (the plain versions never count): the
# forward's tensor-core kernels (bf16 with D % 16 == 0; f32) and FFMA
# kernel, the backward's tensor-core kernels (bf16 at D % 16 == 0, bf16
# zero-padded at other D; f32).
forward_tc_counter = _build.LaunchCounter()
forward_tc_f32_counter = _build.LaunchCounter()
forward_ffma_counter = _build.LaunchCounter()
backward_tc_counter = _build.LaunchCounter()
backward_tc_pad_counter = _build.LaunchCounter()
backward_tc_f32_counter = _build.LaunchCounter()

# The tiny-S envelope (the JAX module's): every per-head score matrix fits
# one CTA's shared memory whole.
MAX_SEQ = 128
MAX_HEAD_DIM = 128

_NEG = -1e30  # the kernels' finite mask value


def _route(dtype: torch.dtype, d: int, train: bool) -> str:
    """The forward's kernel: :func:`_build.attention_route`, except that
    bf16 keeps the FFMA kernel for every inference call and for a training
    call whose D is not a multiple of 16 (the bf16 tensor-core forward is
    instantiated per D % 16 == 0 only; the backward and K8 take such a D
    zero-padded). f32 calls take the f32 tensor-core kernel whether
    training or not.

    Why bf16 inference stays on FFMA: both kernels are within one bf16 ulp of
    the plain version on every element, but the FFMA kernel takes every sum
    in one fixed order (each score one fma chain over d ascending on
    (q·scale, k), l by lane partials and an xor tree, p·v one fma chain over
    the keys ascending), the order its outputs have kept since it was
    written, so served answers do not move when its speed does; the tensor
    cores sum in another order. Served vit_s16 answers then differ from
    the plain path's on a few more near ties (top-2 gaps ≤ 1.1e-3 of the
    max, below bf16's resolution): 3–5 of 256 on the serving check's
    seeded images against the FFMA kernel's 2, past its 99 % rule (H100
    runs; ``PERF.md`` §6)."""
    route = _build.attention_route(dtype, d)
    return "ffma" if route == "tensor_core" and (not train or d % 16) else route


def attention_small_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, *,
    train: bool = False,
) -> torch.Tensor:
    """The forward inside the envelope: for CUDA tensors the kernel of
    :func:`_route` (``train``: the forward of a training step), for CPU
    tensors ``full_attention``. Output [B, S, H, D] in q's dtype,
    contiguous."""
    check_qkv(q, k, v)
    if _build.on_cpu(q, "fused_attention_small"):
        return full_attention(q, k, v, causal=causal)
    bsz, s, h, d = q.shape
    sb, ss, sh = _build.attention_layout(q, k, v, "fused_attention_small", MAX_HEAD_DIM)
    if s > MAX_SEQ:
        raise ValueError(f"fused_attention_small kernel needs S <= {MAX_SEQ}, got S={s}")
    out = torch.empty((bsz, s, h, d), dtype=q.dtype, device=q.device)
    route = _route(q.dtype, d, train)
    if route != "ffma":
        _build.require_16b_rows(q, k, v, "fused_attention_small")
    lib = _build.load_library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), sb, ss, sh)
    with torch.cuda.device(q.device):
        if route == "ffma":
            entry = lib.mpt_attn_small_fwd
        elif route == "tensor_core":
            entry = lib.mpt_attn_small_fwd_tc
        else:
            entry = lib.mpt_attn_small_fwd_tc_f32
        rc = entry(*ptrs, bsz, s, h, d, d**-0.5, int(causal), _build.stream(q.device))
    _build.check(rc, "fused_attention_small forward")
    {"tensor_core": forward_tc_counter, "tensor_core_f32": forward_tc_f32_counter,
     "ffma": forward_ffma_counter}[route].add()
    return out


def attention_small_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, causal: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward, in the kernel's order and
    in f32: p recomputed and normalized, o = p·v, Δ = Σ do·o, ds = p·(dp −
    Δ), dq = ds·k·scale, dk = dsᵀ·q·scale (q unscaled), dv = pᵀ·do; each in
    its operand's dtype."""
    s, d = q.shape[1], q.shape[-1]
    scale = d**-0.5
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, D]
    scores = (qf * scale) @ kf.transpose(-1, -2)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p @ vf
    delta = (dof * o).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ dof
    return tuple(g.transpose(1, 2).to(t.dtype) for g, t in ((dq, q), (dk, k), (dv, v)))


def attention_small_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, causal: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), contiguous [B, S, H, D] in q's dtype: for CUDA
    tensors the kernel of :func:`_build.attention_route`, for CPU tensors
    the plain version. Deterministic: two calls on the same inputs give
    the same bits."""
    check_qkv(q, k, v)
    if _build.on_cpu(q, "fused_attention_small"):
        return attention_small_backward_reference(q, k, v, do, causal)
    bsz, s, h, d = q.shape
    sb, ss, sh = _build.attention_layout(q, k, v, "fused_attention_small", MAX_HEAD_DIM)
    if s > MAX_SEQ:
        raise ValueError(f"fused_attention_small kernel needs S <= {MAX_SEQ}, got S={s}")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or not do.is_contiguous():
        raise ValueError(
            f"fused_attention_small backward needs do contiguous {tuple(q.shape)} "
            f"{q.dtype} on {q.device}"
        )
    dq, dk, dv = (torch.empty((bsz, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    route = _build.attention_route(q.dtype, d)
    if route == "tensor_core_f32":
        _build.require_16b_rows(q, k, v, "fused_attention_small", do)
    lib = _build.load_library()
    entry = lib.mpt_attn_small_bwd_tc if route == "tensor_core" else lib.mpt_attn_small_bwd_tc_f32
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), sb, ss, sh, bsz, s, h, d, d**-0.5, int(causal),
                   _build.stream(q.device))
    _build.check(rc, "fused_attention_small backward")
    if route == "tensor_core_f32":
        backward_tc_f32_counter.add()
    else:
        (backward_tc_pad_counter if d % 16 else backward_tc_counter).add()
    return dq, dk, dv


class _FusedSmall(torch.autograd.Function):
    """The differentiable tiny-S attention: the forward saves q, k, v only;
    the backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return attention_small_forward(q, k, v, causal, train=True)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_small_backward(q, k, v, do.to(q.dtype).contiguous(), ctx.causal)
        return dq, dk, dv, None


def fused_attention_small(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Tiny-S attention over [B, S, H, D] inputs, the same function as
    ``full_attention``. Inside the envelope (S ≤ 128, D ≤ 128) the forward
    kernel (inference) or, with a gradient to take, :class:`_FusedSmall`
    (the training forward and the backward); outside it
    ``full_attention``."""
    check_qkv(q, k, v)
    if q.shape[1] > MAX_SEQ or q.shape[-1] > MAX_HEAD_DIM:
        return full_attention(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedSmall.apply(q, k, v, causal)
    return attention_small_forward(q, k, v, causal)
