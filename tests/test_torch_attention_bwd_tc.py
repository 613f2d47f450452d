"""The arithmetic of the tensor-core tiny-S attention backward (K10), on the
CPU, against the JAX package.

For bf16 (any D % 4 == 0) the backward of ``fused_attention_small`` runs on
Hopper's tensor cores (``attn_small_bwd_tc_kernel`` in
``csrc/fused_attention_small.cu``): s = q·kᵀ and dp = do·vᵀ are exact bf16
products summed in f32, the scale applied to the f32 scores; p = 2^((s −
m)·log2 e) over the whole row, divided by its sum before any use; Δ = Σ_j
p·dp (the JAX kernel's Σ_d do·o without recomputing o); ds = p·(dp − Δ);
and every product of the f32 p or ds with a bf16 operand (dv = pᵀ·do, dq
= ds·k·scale, dk = dsᵀ·q·scale) takes the first three bf16 terms of p or
ds (t0 = bf16(x), t1 = bf16(x − t0), t2 = bf16(x − t0 − t1)), each times
the bf16 operand an exact product, summed in f32. No CUDA kernel runs
here, so a torch emulation of those numerics
(``ops/attention_split_numerics.emulate_small_backward_bf16``) is held against
``jax.vjp`` through the JAX ``fused_attention_small`` kernel in Pallas
interpret mode, as its own tests run it, on numpy-seeded bf16 q, k, v and
do at vit_s16's head shape (H = 6, D = 64) with a small batch.

Tolerances:
- the f32 gradients before rounding within 1e-5 · max|reference| of the
  JAX kernel's on the same values in f32: f32 sums in another order;
- the bf16-rounded gradients within the card's check of the kernel
  (``chip_smoke._grad_check``: one bf16 ulp of the reference plus 1e-4 of
  its largest magnitude).
A single bf16 term of p and ds (off by up to 2^-8) misses both, at every
case: it is a different function. The route rule (which dtypes and head
dims reach which kernel) is checked case by case, and CPU tensors launch
no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
    emulate_small_backward_bf16 as emulate_backward,
)

B, H, D = 2, 6, 64
F32_REL = 1e-5

CASES = [(64, False), (50, False), (65, False), (128, False), (64, True)]
IDS = [f"s{s}{'_causal' if c else ''}" for s, c in CASES]


def _inputs(seed: int, s: int) -> list[torch.Tensor]:
    """q, k, v, do [B, S, H, D]: numpy-seeded normals rounded to bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(4)]


def _jax_grads(q, k, v, do, causal: bool) -> list[np.ndarray]:
    """``jax.vjp`` through the JAX kernel (interpret mode) on the same
    values in f32: (dq, dk, dv)."""
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: jax_fused_small(*a, causal=causal, interpret=True), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]


def _f32_gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got − want| over max |want|."""
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _grad_check_ratio(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest |bf16(got) − want| over the card's tolerance, 2^-7·|want|
    + 1e-4·max|want| (``chip_smoke._grad_check``): ≤ 1 passes."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((np.abs(g - want) / (2.0**-7 * np.abs(want) + 1e-4 * np.abs(want).max())).max())


@pytest.mark.parametrize("s,causal", CASES, ids=IDS)
def test_split_terms_match_jax(s, causal):
    q, k, v, do = _inputs(500 + s + causal, s)
    want = _jax_grads(q, k, v, do, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), emulate_backward(q, k, v, do, causal), want):
        assert _f32_gap(got, ref) <= F32_REL, name
        assert _grad_check_ratio(got, ref) <= 1, name


@pytest.mark.parametrize("s,causal", CASES, ids=IDS)
def test_a_single_bf16_term_fails_both_checks(s, causal):
    """t0 alone (a bf16 p and ds) is a different function: some gradient
    misses the f32 tolerance by two orders of magnitude and the card's
    check."""
    q, k, v, do = _inputs(500 + s + causal, s)
    want = _jax_grads(q, k, v, do, causal)
    single = emulate_backward(q, k, v, do, causal, terms=1)
    assert max(_f32_gap(g, r) for g, r in zip(single, want)) > 100 * F32_REL
    assert max(_grad_check_ratio(g, r) for g, r in zip(single, want)) > 1


def test_delta_from_p_dp_equals_delta_from_o():
    """Δ = Σ_j p·dp (the kernel's) and Δ = Σ_d do·o (the JAX kernel's, o =
    p·v recomputed) agree to f32 rounding: the same function."""
    q, k, v, do = (t.float().transpose(1, 2) for t in _inputs(600, 64))
    sc = (q @ k.transpose(-1, -2)) * D**-0.5
    p = torch.softmax(sc, -1)
    dp = do @ v.transpose(-1, -2)
    via_p = (p * dp).sum(-1)
    via_o = (do * (p @ v)).sum(-1)
    assert float((via_p - via_o).abs().max() / via_o.abs().max()) < 1e-6


@pytest.mark.parametrize(
    "dtype,d,route",
    [
        (torch.bfloat16, 64, "tensor_core"),
        (torch.bfloat16, 16, "tensor_core"),
        (torch.bfloat16, 32, "tensor_core"),
        (torch.bfloat16, 128, "tensor_core"),
        (torch.bfloat16, 40, "tensor_core"),
        (torch.bfloat16, 8, "tensor_core"),
        (torch.bfloat16, 144, "ffma"),
        (torch.float32, 64, "tensor_core_f32"),
        (torch.float32, 128, "tensor_core_f32"),
    ],
)
def test_backward_route(dtype, d, route):
    """bf16 with D % 4 == 0 and D ≤ 128 takes the bf16 tensor-core
    backward (a D that is not a multiple of 16 zero-padded to the next
    one, ``test_torch_attention_pad_tc.py``), f32 with D % 4 == 0 and
    D ≤ 128 the f32 tensor-core backward (six term-pair products,
    ``test_torch_attention_bwd_f32_tc.py``). The backward has no inference
    caller: it takes the rule as it is, and so does the tiny-S training
    forward, except that a bf16 D that is not a multiple of 16 keeps its
    FFMA forward."""
    assert _build.attention_route(dtype, d) == route
    padded_bf16 = dtype == torch.bfloat16 and d % 16 != 0
    assert fas._route(dtype, d, train=True) == ("ffma" if padded_bf16 else route)


def test_cpu_tensors_launch_no_backward():
    """On CPU tensors the backward runs its plain version on every route's
    inputs, and no backward counter moves."""
    counters = (fas.backward_tc_counter, fas.backward_tc_pad_counter, fas.backward_tc_f32_counter)
    before = [c.count for c in counters]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (t.to(dtype) for t in _inputs(700, 64))
        got = fas.attention_small_backward(q, k, v, do)
        want = fas.attention_small_backward_reference(q, k, v, do)
        assert all(torch.equal(a, b) and a.dtype == dtype for a, b in zip(got, want))
    assert [c.count for c in counters] == before
