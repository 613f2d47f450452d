"""The arithmetic of the f32 tensor-core attention forwards, on the CPU,
against the JAX package.

The f32 route of K8 (``flash_forward``) and of K9
(``attention_small_forward``, training and inference) runs on Hopper's
tensor cores (``csrc/attention_tc.cuh``): q·scale, k, v and p each split
into three bf16 terms (t0 = bf16(x), t1 = bf16(x − t0), t2 = bf16(x − t0
− t1), each rounded to nearest), and every product keeps the six term
pairs (i, j) with i + j ≤ 2 — a0b0, a0b1, a1b0, a0b2, a1b1, a2b0 — each an
exact bf16 product, summed in f32; p = 2^((s − m)·log2 e) as the hardware's
base-2 exponential takes it; the output is (p·v) ÷ l. No CUDA kernel runs
here, so the torch emulation of those numerics
(``ops/attention_split_numerics.py``: whole-row for K9, key blocks of 64
with the online recurrence for K8, as the kernels tile) is held against the JAX ``fused_attention_small`` and ``flash_attention``
kernels run in f32 in Pallas interpret mode, as their own tests run them,
on numpy-seeded standard-normal q, k, v at vit_s16's H = 6 with a small
batch, at D = 64 and at a D that is not a multiple of 16 (40: the kernels
zero the padding columns).

Tolerances:
- the output within 2e-6·max|ref| of the JAX f32 kernel's (f32 sums in
  another order: the six pairs keep every product to ~2^-24 relative, so
  the gap is f32 rounding);
- K8's logsumexp within 1e-5 of the JAX kernel's (the card's lse check).
A guard test shows that three term pairs (i + j ≤ 1, the products of
order 2^-8 and above) leave that output tolerance: a different function
at the level the f32 checks read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.flash_attention import _fwd_impl as jax_flash_fwd
from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
    F64_REL, SIX, THREE, attention_f64, emulate_flash, emulate_small, relative_gap, split3,
)

B, H = 2, 6
OUT_REL = 2e-6
LSE_TOL = 1e-5


def _qkv(seed: int, s: int, d: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(np.float32)) for _ in range(3)]


def _jax_small(q, k, v, causal: bool) -> np.ndarray:
    args = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    return np.asarray(jax_fused_small(*args, causal=causal, interpret=True))


def _jax_flash(q, k, v, causal: bool) -> tuple[np.ndarray, np.ndarray]:
    """The JAX flash forward (``_fwd_impl``, blocks as its wrapper cuts
    them) in f32 in interpret mode: (out [B, S, H, D], lse [B, H, S])."""
    s, d = q.shape[1], q.shape[-1]
    blk = min(128, max(8, s))
    to3 = lambda t: jnp.asarray(t.numpy()).transpose(0, 2, 1, 3).reshape(B * H, s, d)  # noqa: E731
    out, lse = jax_flash_fwd(to3(q), to3(k), to3(v), causal=causal, block_q=blk, block_k=blk,
                             interpret=True)
    out = np.asarray(out).reshape(B, H, s, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :s].reshape(B, H, s)


def _gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got − want| over max |want|: the relative gap the tolerance
    bounds."""
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


SMALL_CASES = [(64, False), (50, False), (65, False), (128, False), (64, True)]
FLASH_CASES = [(196, False), (200, False), (196, True)]
DIMS = [64, 40]
IDS = lambda cases: [f"s{s}{'_causal' if c else ''}" for s, c in cases]  # noqa: E731


@pytest.mark.parametrize("d", DIMS, ids=[f"d{d}" for d in DIMS])
@pytest.mark.parametrize("s,causal", SMALL_CASES, ids=IDS(SMALL_CASES))
def test_small_six_products_match_jax(s, causal, d):
    q, k, v = _qkv(500 + s + d, s, d)
    assert _gap(emulate_small(q, k, v, causal), _jax_small(q, k, v, causal)) <= OUT_REL


@pytest.mark.parametrize("d", DIMS, ids=[f"d{d}" for d in DIMS])
@pytest.mark.parametrize("s,causal", FLASH_CASES, ids=IDS(FLASH_CASES))
def test_flash_six_products_match_jax(s, causal, d):
    q, k, v = _qkv(600 + s + d, s, d)
    got, lse = emulate_flash(q, k, v, causal)
    want, want_lse = _jax_flash(q, k, v, causal)
    assert _gap(got, want) <= OUT_REL
    assert float(np.abs(lse.numpy() - want_lse).max()) <= LSE_TOL


@pytest.mark.parametrize("kernel", ["small", "flash"])
def test_three_products_break_the_tolerance(kernel):
    """The three pairs of order 2^-8 and above (a0b0, a0b1, a1b0) leave the
    output past the tolerance the six keep: the pairs of order 2^-16 are
    part of the f32 function."""
    if kernel == "small":
        q, k, v = _qkv(700, 64, 64)
        want = _jax_small(q, k, v, False)
        six, three = (emulate_small(q, k, v, False, pairs) for pairs in (SIX, THREE))
    else:
        q, k, v = _qkv(701, 196, 64)
        want = _jax_flash(q, k, v, False)[0]
        six, three = (emulate_flash(q, k, v, False, pairs)[0] for pairs in (SIX, THREE))
    assert _gap(six, want) <= OUT_REL
    assert _gap(three, want) > OUT_REL


def test_split_keeps_f32_to_its_last_bits():
    """Three terms keep an f32 value to ~2^-24 relative (the residual after
    t2 is below bf16's rounding of the second residual), two to ~2^-16."""
    x = torch.from_numpy(np.random.default_rng(702).standard_normal(4096).astype(np.float32))
    t = split3(x)
    three = ((x.double() - sum(ti.double() for ti in t)).abs() / x.double().abs()).max()
    two = ((x.double() - (t[0].double() + t[1].double())).abs() / x.double().abs()).max()
    assert float(three) <= 2.0**-24
    assert 2.0**-20 < float(two) <= 2.0**-16


@pytest.mark.parametrize("kernel", ["small", "flash"])
def test_float64_limit_parts_six_pairs_from_three(kernel):
    """Against float64 attention, the limit ``chip_smoke.py`` holds the
    kernels to on the card (``F64_REL``) passes the six pairs and fails
    the three, and so does this file's tolerance: both read the pairs, not
    the JAX kernel's own f32 rounding."""
    q, k, v = _qkv(703, 64 if kernel == "small" else 196, 64)
    ref, ref_lse = attention_f64(q, k, v)
    if kernel == "small":
        six, three = (emulate_small(q, k, v, False, pairs) for pairs in (SIX, THREE))
    else:
        (six, lse), (three, _) = (emulate_flash(q, k, v, False, pairs) for pairs in (SIX, THREE))
        assert float((lse.double() - ref_lse).abs().max()) <= LSE_TOL
    assert relative_gap(six, ref) <= OUT_REL < F64_REL < relative_gap(three, ref)
