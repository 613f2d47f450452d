"""The arithmetic of the tensor-core attention kernels in plain torch,
and the float64 attention the f32 ones are held against.

The f32 route of K8 (``flash_forward``) and of K9
(``attention_small_forward``) runs on Hopper's tensor cores
(``csrc/attention_tc.cuh``): q·scale, k, v and p each split into three
bf16 terms (t0 = bf16(x), t1 = bf16(x − t0), t2 = bf16(x − t0 − t1), each
rounded to nearest), and every product keeps the six term pairs (i, j)
with i + j ≤ 2 — a0b0, a0b1, a1b0, a0b2, a1b1, a2b0 — each an exact bf16
product, summed in f32; p = 2^((s − m)·log2 e) as the hardware's base-2
exponential takes it; the output is (p·v) ÷ l. :func:`emulate_small`
(whole-row, as K9) and :func:`emulate_flash` (key blocks of 64 with the
online recurrence, as K8) compute that with torch operations on any
device; ``pairs=THREE`` keeps only the pairs of order 2^-8 and above, the
control that shows the other three are part of the f32 function. K10's f32
route (``attention_small_backward``) takes every one of its five products
the same way: :func:`emulate_small_backward`.

The bf16 route of K8, K9's training forward and K10 takes q·kᵀ and do·vᵀ
as exact bf16 products summed in f32, the scale applied to the f32 scores
afterwards, and every product of the f32 p or ds with a bf16 operand (p·v,
pᵀ·do, ds·k, dsᵀ·q) as the first three bf16 terms of p or ds, each times
the bf16 operand an exact product, summed in f32 (largest first):
:func:`emulate_small_bf16`, :func:`emulate_flash_bf16` and
:func:`emulate_small_backward_bf16`. A head dim D that is not a multiple of
16 runs zero-padded to DK = D rounded up to 16: the emulations take q, k, v
(and do) with their last dim already padded (:func:`pad_head`) and the real
``d`` for the scale, so a test can show that zero padding columns change no
bit of the first D output columns and that stale ones do.

No kernel calls these: the tests hold them against the JAX kernels, and
``chip_smoke.py`` holds the f32 ones and the kernels against
:func:`attention_f64` and :func:`attention_backward_f64` on the card's
inputs.
"""

from __future__ import annotations

import torch

NEG = -1e30  # the kernels' mask value
KEY_BLOCK = 64  # the flash kernel's k/v block
LOG2E = 1.4426950408889634
# The f32 tensor-core kernels against :func:`attention_f64` and
# :func:`attention_backward_f64` (max |error| over max |reference|,
# ``relative_gap``; for the backward the largest of dq's, dk's and dv's): a
# limit that the six pairs keep — their emulation here reads a few 1e-7
# (forwards 4e-7 to 7e-7, the backward 2e-7 to 4e-7 on the CPU), the
# forwards on an H100 up to about 2e-6, since a wgmma's f32 sum is not
# rounded to nearest — and three pairs, the control, break (forwards near
# 1e-5, the backward 8e-6 to 1.6e-5).
F64_REL = 4e-6
# The term pairs (i, j) of a product, largest first (the kernels sum them
# smallest first).
SIX = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
THREE = SIX[:3]


def split3(x: torch.Tensor) -> list[torch.Tensor]:
    """The three bf16 terms of f32 x (as f32 values): each rounds the
    residual left by the ones before, which is exact in f32."""
    terms = []
    for _ in range(3):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor, pairs=SIX) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the kernels take it: the term pairs
    ``pairs`` of the two splits, each an exact product of bf16 values (exact
    in f32 and in TF32 alike), summed in f32, smallest first."""
    ta, tb = split3(a), split3(b)
    out = 0.0
    for i, j in reversed(pairs):
        out = out + torch.einsum(eq, ta[i], tb[j])
    return out


def _scores(q, k, causal: bool, pairs) -> torch.Tensor:
    """[B, H, S, S] f32: (q·scale)·kᵀ from the splits of q·scale and k;
    −1e30 past the diagonal when causal."""
    s = q.shape[1]
    sc = split_product("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k, pairs)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), NEG)
    return sc


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp as the kernels take it: 2^(x·log2 e), the product rounded to f32."""
    return torch.exp2(x * torch.tensor(LOG2E, dtype=torch.float32, device=x.device))


def emulate_small(q, k, v, causal: bool = False, pairs=SIX) -> torch.Tensor:
    """K9's f32 tensor-core arithmetic on f32 [B, S, H, D] q, k, v:
    whole-row softmax, out = (p·v) / l, [B, S, H, D]."""
    sc = _scores(q, k, causal, pairs)
    p = _exp(sc - sc.amax(-1, keepdim=True))
    pv = split_product("bhqk,bhkd->bhqd", p, v.transpose(1, 2), pairs)
    return (pv / p.sum(-1, keepdim=True)).transpose(1, 2)


def emulate_flash(q, k, v, causal: bool = False, pairs=SIX) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's f32 tensor-core arithmetic on f32 [B, S, H, D] q, k, v: key
    blocks of 64 (the last padded with −1e30 keys and zero values), the
    online recurrence m, l, acc·α; out = acc / safe_l [B, S, H, D] and
    lse = m + log(safe_l) [B, H, S]."""
    b, s, h, d = q.shape
    n = -(-s // KEY_BLOCK) * KEY_BLOCK
    sc = torch.nn.functional.pad(_scores(q, k, causal, pairs), (0, n - s), value=NEG)
    vt = torch.nn.functional.pad(v.transpose(1, 2), (0, 0, 0, n - s))
    m = torch.full((b, h, s, 1), NEG, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for k0 in range(0, n, KEY_BLOCK):
        blk = sc[..., k0:k0 + KEY_BLOCK]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = _exp(blk - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + split_product("bhqk,bhkd->bhqd", p, vt[:, :, k0:k0 + KEY_BLOCK], pairs)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).transpose(1, 2), (m + torch.log(safe_l))[..., 0]


def emulate_small_backward(q, k, v, do, causal: bool = False, pairs=SIX):
    """K10's f32 tensor-core arithmetic on f32 [B, S, H, D] q, k, v, do:
    p = 2^((s − m)·log2 e) / l over the whole row from s = (q·scale)·kᵀ,
    dp = do·vᵀ, Δ = Σ_j p·dp, ds = p·(dp − Δ), dq = ds·k·scale, dk =
    dsᵀ·(q·scale) (q's scaled terms serve both products), dv = pᵀ·do, every
    product as ``split_product``. Returns (dq, dk, dv), [B, S, H, D]."""
    qs = q * q.shape[-1] ** -0.5
    sc = _scores(q, k, causal, pairs)
    e = _exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = split_product("bqhd,bkhd->bhqk", do, v, pairs)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = split_product("bhqk,bkhd->bqhd", ds, k, pairs) * q.shape[-1] ** -0.5
    dk = split_product("bhqk,bqhd->bkhd", ds, qs, pairs)
    dv = split_product("bhqk,bqhd->bkhd", p, do, pairs)
    return dq, dk, dv


def pad_head(x: torch.Tensor, dk: int, value: torch.Tensor | float = 0.0) -> torch.Tensor:
    """x [.., D] widened to dk columns, the new ones ``value`` (a scalar, or
    a tensor of x's shape but dk − D columns): as the bf16 kernels stage a
    head dim that is not a multiple of 16, whose padding columns must be
    zero."""
    if not isinstance(value, torch.Tensor):
        value = torch.full((*x.shape[:-1], dk - x.shape[-1]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, value.to(x.dtype)], dim=-1)


def _bf16_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """[B, H, S, S] f32: exact bf16 products summed in f32, then · scale;
    −1e30 past the diagonal when causal."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), NEG)
    return sc


def _split_mm(x: torch.Tensor, y: torch.Tensor, terms: int) -> torch.Tensor:
    """x (f32) times y (bf16 values) as the bf16 kernels take it: each of
    the first ``terms`` bf16 terms of x (``split3``) times y, an exact
    product, summed in f32, largest first."""
    return sum(t @ y.float() for t in split3(x)[:terms])


def _scale(q: torch.Tensor, d: int | None) -> float:
    return (q.shape[-1] if d is None else d) ** -0.5


def emulate_small_bf16(q, k, v, causal: bool = False, terms: int = 3, d: int | None = None):
    """K9's bf16 tensor-core arithmetic on bf16 [B, S, H, DK] q, k, v
    (columns past ``d`` the padding; ``d`` defaults to DK): whole-row
    softmax, out = (p·v) / l, f32 [B, S, H, DK] before the bf16 rounding."""
    sc = _bf16_scores(q, k, causal, _scale(q, d))
    p = _exp(sc - sc.amax(-1, keepdim=True))
    return (_split_mm(p, v.transpose(1, 2), terms) / p.sum(-1, keepdim=True)).transpose(1, 2)


def emulate_flash_bf16(q, k, v, causal: bool = False, terms: int = 3, d: int | None = None):
    """K8's bf16 tensor-core arithmetic on bf16 [B, S, H, DK] q, k, v
    (columns past ``d`` the padding): key blocks of 64 (the last padded
    with −1e30 keys and zero values; the kernel's narrower last block adds
    the same padded keys' exact zeros), the online recurrence m, l, acc·α;
    out = acc / safe_l (f32 [B, S, H, DK] before rounding) and lse = m +
    log(safe_l) [B, H, S]."""
    b, s, h, dk = q.shape
    n = -(-s // KEY_BLOCK) * KEY_BLOCK
    sc = torch.nn.functional.pad(_bf16_scores(q, k, causal, _scale(q, d)), (0, n - s), value=NEG)
    vt = torch.nn.functional.pad(v.transpose(1, 2), (0, 0, 0, n - s))
    m = torch.full((b, h, s, 1), NEG, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, dk), device=q.device)
    for k0 in range(0, n, KEY_BLOCK):
        blk = sc[..., k0:k0 + KEY_BLOCK]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = _exp(blk - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_mm(p, vt[:, :, k0:k0 + KEY_BLOCK], terms)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).transpose(1, 2), (m + torch.log(safe_l))[..., 0]


def emulate_small_backward_bf16(q, k, v, do, causal: bool = False, terms: int = 3,
                                d: int | None = None):
    """K10's bf16 tensor-core arithmetic on bf16 [B, S, H, DK] q, k, v, do
    (columns past ``d`` the padding): s = q·kᵀ·scale and dp = do·vᵀ exact
    products summed in f32, p = 2^((s − m)·log2 e) / l over the whole row,
    Δ = Σ_j p·dp, ds = p·(dp − Δ), dq = ds·k·scale, dk = dsᵀ·q·scale, dv =
    pᵀ·do, p and ds by their first ``terms`` bf16 terms. Returns (dq, dk,
    dv), f32 [B, S, H, DK] before the bf16 rounding."""
    s = q.shape[1]
    scale = _scale(q, d)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))  # [B, H, S, DK]
    sc = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), NEG)
    e = _exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = dof @ vf.transpose(-1, -2)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = _split_mm(ds, kf, terms) * scale
    dk = _split_mm(ds.transpose(-1, -2), qf, terms) * scale
    dv = _split_mm(p.transpose(-1, -2), dof, terms)
    return tuple(g.transpose(1, 2) for g in (dq, dk, dv))


def attention_backward_f64(q, k, v, do, causal: bool = False) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of softmax((q·D^-0.5)·kᵀ)·v against the output
    gradient do, in float64, from [B, S, H, D] inputs: [B, S, H, D] each."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        s = q.shape[1]
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), float("-inf"))
    p = torch.softmax(sc, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq, dk, dv


def attention_f64(q, k, v, causal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax((q·D^-0.5)·kᵀ)·v in float64 from [B, S, H, D] q, k, v:
    (out [B, S, H, D], lse [B, H, S]), both float64."""
    q, k, v = (t.double() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    if causal:
        s = q.shape[1]
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=q.device).tril(), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    return out, torch.logsumexp(sc, -1)


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|, in float64."""
    got, want = got.double(), want.double().to(got.device)
    return float((got - want).abs().max() / want.abs().max())
