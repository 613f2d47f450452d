"""K9's bf16 inference forward — ``attn_small_fwd_kernel`` of
``csrc/fused_attention_small.cu``, the kernel vit_s16's serving and
validation run — in its order of reduction, held on the CPU against the
JAX ``fused_attention_small`` forward (Pallas interpret mode) and the
port's ``full_attention``.

A CUDA kernel cannot run here, so :func:`emulate_infer` repeats the
kernel's arithmetic in torch, step by step, on bf16 q, k, v (exact in f32):

- q·scale rounded to f32;
- each score one fma chain over d ascending from 0: each step a·b + c in
  float64 (the product of two f32 values is exact there), then rounded to
  f32;
- keys past S, and past the query when causal, at −1e30; m the row's max;
- p = exp(s − m) in f32;
- l as ``row_softmax`` forms it: lane L of 32 sums p over columns L,
  L + 32, ... ascending from 0, then the xor tree adds lane L ^ o for
  o = 16, 8, 4, 2, 1;
- out: one fma chain over the keys ascending (the same float64 steps), then
  ÷ l, rounded to bf16.

Tolerance: one bf16 ulp of the larger magnitude plus 1e-6, the kernel's
own check on the card. The emulation, the JAX kernel and ``full_attention``
compute the same f32 function in different summation orders (f32
differences of a few 1e-7 relative) and each rounds it to bf16, so two of
them may land one bf16 step apart, never more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

NEG = -1e30
B, H = 2, 3


def _fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_r a[..., i, r]·b[..., j, r] as one fma chain over r ascending
    from 0: every step rounds the exact a·b + c to f32 (a, b f32)."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    for r in range(a.shape[-1]):
        acc = (a64[..., :, None, r] * b64[..., None, :, r] + acc.double()).float()
    return acc


def _row_softmax_sum(p: torch.Tensor) -> torch.Tensor:
    """Σ_j p[..., j] as ``row_softmax`` takes it: 32 lane partials over
    columns L, L + 32, ... ascending from 0, then the xor tree."""
    s = p.shape[-1]
    lanes = torch.zeros(p.shape[:-1] + (32,), dtype=torch.float32)
    for j in range(s):
        lanes[..., j % 32] = lanes[..., j % 32] + p[..., j]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    return lanes[..., 0]


def emulate_infer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The kernel's output for bf16 [B, S, H, D] q, k, v (module docstring)."""
    s, d = q.shape[1], q.shape[-1]
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    qs, kf, vf = (q.float() * scale).transpose(1, 2), k.float().transpose(1, 2), v.float().transpose(1, 2)
    scores = _fma_chain(qs, kf)  # [B, H, S, S]
    if causal:
        scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), NEG)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    l = _row_softmax_sum(p)
    out = _fma_chain(p, vf.transpose(-1, -2))  # [B, H, S, D]: keys ascending
    return (out / l[..., None]).to(torch.bfloat16).transpose(1, 2)


def _ulp_close(got: torch.Tensor, want: torch.Tensor) -> None:
    g, w = got.float(), want.float()
    tol = 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 1e-6
    err = (g - w).abs()
    assert bool((err <= tol).all()), f"{int((err > tol).sum())} values beyond one bf16 ulp, max {float(err.max())}"


def _inputs(seed: int, s: int, d: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


CASES = [(8, 16, False), (24, 40, False), (50, 64, False), (64, 64, False), (64, 64, True),
         (33, 16, True), (64, 40, True)]


@pytest.mark.parametrize("s,d,causal", CASES, ids=[f"s{s}_d{d}{'_causal' if c else ''}" for s, d, c in CASES])
def test_kernel_order_matches_pallas_and_plain(s, d, causal):
    """The emulated kernel against the JAX Pallas forward and the port's
    plain ``full_attention``, one bf16 ulp plus 1e-6 each."""
    q, k, v = _inputs(100 * s + d, s, d)
    got = emulate_infer(q, k, v, causal)
    want = jax_fused_small(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
                           causal=causal, interpret=True)
    _ulp_close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))
    _ulp_close(got, full_attention(q, k, v, causal=causal))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, s, H, d)


def test_lane_tree_sum_is_its_own_order():
    """l's order is a stated one: the lane partials and the xor tree give
    the exact sum on values that add without rounding, and differ in the
    last bits from a left-to-right sum on values that do not — so the
    emulation holds the kernel to that order, not merely to a sum."""
    exact = torch.arange(1, 65, dtype=torch.float32)[None]
    assert float(_row_softmax_sum(exact)[0]) == 64 * 65 / 2
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.random((256, 64)).astype(np.float32))
    seq = torch.zeros(256)
    for j in range(64):
        seq = seq + p[:, j]
    tree = _row_softmax_sum(p)
    assert bool((tree != seq).any())
    assert torch.allclose(tree, seq, rtol=1e-6, atol=0)


def test_fma_chain_rounds_each_step_once():
    """A step of the chain is fmaf's one rounding of the exact a·b + c:
    with c = −(1 + 2^-11) and a = b = 1 + 2^-12 it keeps the 2^-24 that a
    product rounded to f32 first would lose."""
    a = torch.tensor([[1.0, 1 + 2.0**-12]], dtype=torch.float32)
    b = torch.tensor([[-(1 + 2.0**-11), 1 + 2.0**-12]], dtype=torch.float32)
    assert float(_fma_chain(a, b)[0, 0]) == 2.0**-24
    assert float(a[0, 0] * b[0, 0] + a[0, 1] * b[0, 1]) == 0.0


def test_bf16_inference_keeps_the_ffma_route():
    """vit_s16's serving and validation calls (bf16, D = 64, no gradient)
    take the FFMA kernel, whose order the emulation holds; its training
    forward takes the tensor cores."""
    assert fas._route(torch.bfloat16, 64, train=False) == "ffma"
    assert fas._route(torch.bfloat16, 64, train=True) == "tensor_core"
    assert fas._route(torch.bfloat16, 40, train=True) == "ffma"
