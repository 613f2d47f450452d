"""The arithmetic of the f32 tensor-core tiny-S attention backward (K10's
f32 route), on the CPU, against the JAX package.

For f32 with D % 4 == 0 and D ≤ 128 the backward of
``fused_attention_small`` runs on Hopper's tensor cores
(``attn_small_bwd_tc_f32_kernel`` in ``csrc/fused_attention_small.cu``):
q·scale, k, v and do are split into three bf16 terms (t0 = bf16(x), t1 =
bf16(x − t0), t2 = bf16(x − t0 − t1)), and so are p and ds; every one of
the five products (s = (q·scale)·kᵀ, dp = do·vᵀ, dv = pᵀ·do, dq =
ds·k·scale, dk = dsᵀ·(q·scale)) keeps the six term pairs (i, j) with
i + j ≤ 2, each an exact bf16 product, summed in f32; p = 2^((s −
m)·log2 e) over the whole row, divided by its sum before any use; Δ =
Σ_j p·dp. No CUDA kernel runs here, so the torch emulation of those
numerics (``attention_split_numerics.emulate_small_backward``) is held
against ``jax.vjp`` through the JAX ``fused_attention_small`` kernel in f32
in Pallas interpret mode, as its own tests run it, on numpy-seeded
standard-normal q, k, v and do at vit_s16's H = 6 with B = 2, at D = 64 and
at D = 40 (not a multiple of 16: the kernel zeroes the padding columns).

Tolerance: each gradient within 2e-6·max|reference| of the JAX kernel's
(both f32 sums in other orders; the six pairs keep every product to
~2^-24 relative, so the gap is f32 rounding: up to 8e-7 on these cases). A
guard test shows that three pairs (i + j ≤ 1, the products of order 2^-8
and above) leave that tolerance (8e-6 and more), and another that the
float64 limit the card holds the kernel to (``F64_REL``) parts six pairs
from three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
    F64_REL, SIX, THREE, attention_backward_f64, emulate_small_backward, relative_gap,
)

B, H = 2, 6
GRAD_REL = 2e-6

CASES = [(64, False), (50, False), (65, False), (128, False), (64, True)]
IDS = [f"s{s}{'_causal' if c else ''}" for s, c in CASES]
DIMS = [64, 40]


def _inputs(seed: int, s: int, d: int) -> list[torch.Tensor]:
    """q, k, v, do [B, S, H, D]: numpy-seeded f32 standard normals."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(np.float32)) for _ in range(4)]


def _jax_grads(q, k, v, do, causal: bool) -> list[np.ndarray]:
    """``jax.vjp`` through the JAX kernel (interpret mode) on the same f32
    values: (dq, dk, dv)."""
    args = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: jax_fused_small(*a, causal=causal, interpret=True), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def _gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got − want| over max |want|."""
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d", DIMS, ids=[f"d{d}" for d in DIMS])
@pytest.mark.parametrize("s,causal", CASES, ids=IDS)
def test_six_products_match_jax(s, causal, d):
    q, k, v, do = _inputs(800 + s + d + causal, s, d)
    want = _jax_grads(q, k, v, do, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), emulate_small_backward(q, k, v, do, causal), want):
        assert _gap(got, ref) <= GRAD_REL, name


@pytest.mark.parametrize("d", DIMS, ids=[f"d{d}" for d in DIMS])
def test_three_products_break_the_tolerance(d):
    """The three pairs of order 2^-8 and above (a0b0, a0b1, a1b0) leave some
    gradient past the tolerance the six keep: the pairs of order 2^-16 are
    part of the f32 function."""
    q, k, v, do = _inputs(900 + d, 64, d)
    want = _jax_grads(q, k, v, do, False)
    six, three = (emulate_small_backward(q, k, v, do, False, pairs) for pairs in (SIX, THREE))
    assert max(_gap(g, r) for g, r in zip(six, want)) <= GRAD_REL
    assert max(_gap(g, r) for g, r in zip(three, want)) > GRAD_REL


@pytest.mark.parametrize("s,causal", [(64, False), (128, False), (64, True)],
                         ids=["s64", "s128", "s64_causal"])
def test_float64_limit_parts_six_pairs_from_three(s, causal):
    """Against float64 gradients, the limit ``chip_smoke.py`` holds the
    kernel to on the card (``F64_REL``, the largest gap of dq, dk, dv)
    passes the six pairs and fails the three, and so does this file's
    tolerance: both read the pairs, not the JAX kernel's own f32
    rounding."""
    q, k, v, do = _inputs(950 + s + causal, s, 64)
    ref = attention_backward_f64(q, k, v, do, causal)
    six, three = (max(map(relative_gap, emulate_small_backward(q, k, v, do, causal, pairs), ref))
                  for pairs in (SIX, THREE))
    assert six <= GRAD_REL < F64_REL < three


def test_float64_gradients_match_autograd():
    """``attention_backward_f64`` is the gradient of float64 attention: it
    equals torch autograd through softmax((q·scale)·kᵀ)·v in float64."""
    q, k, v, do = (t.double() for t in _inputs(990, 50, 40))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", leaves[0] * 40**-0.5, leaves[1])
    torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), leaves[2]).backward(do)
    for got, leaf in zip(attention_backward_f64(q, k, v, do), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-12, atol=1e-12)
