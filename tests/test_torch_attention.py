"""The port's attention functions against the JAX package's, on the CPU.

``full_attention``, ``fused_attention_small`` and ``flash_attention`` of
``mpi_pytorch_tpu_torch.ops`` take the same numpy-seeded [B, S, H, D]
inputs as their JAX counterparts; the JAX kernels run in Pallas interpret
mode, as ``tests/test_fused_attention_small.py`` and
``tests/test_flash_attention.py`` run them, and the port's wrappers run
their plain versions (``full_attention`` forwards, the recompute backward
of the tiny-S kernel, the blocked backward of flash) because the tensors
lie on the CPU.

Tolerances, all f32: values rtol/atol 2e-5 and gradients rtol/atol 5e-5,
the JAX attention tests' own (sums of up to 200 f32 terms in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.flash_attention import flash_attention as jax_flash
from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu.ops.ring_attention import full_attention as jax_full
from mpi_pytorch_tpu_torch.ops import flash_attention as fa
from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

B, H, D = 2, 2, 64

PORT = {
    "full": full_attention,
    "fused-small": fas.fused_attention_small,
    "flash": fa.flash_attention,
}
JAX = {
    "full": jax_full,
    "fused-small": lambda q, k, v, causal: jax_fused_small(q, k, v, causal=causal, interpret=True),
    "flash": lambda q, k, v, causal: jax_flash(q, k, v, causal=causal, interpret=True),
}


def _qkv(seed: int, s: int, d: int = D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H, d)).astype(np.float32) for _ in range(4)]


def _port_value_and_grads(fn, q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_value_and_grads(fn, q, k, v, do, causal):
    out, vjp = jax.vjp(lambda *a: fn(*a, causal=causal), *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("impl", ["full", "fused-small", "flash"])
@pytest.mark.parametrize(
    "s,causal", [(64, False), (50, False), (65, False), (64, True)],
    ids=["s64", "s50_padded", "s65_odd", "s64_causal"],
)
def test_values_and_grads_match_jax(impl, s, causal):
    q, k, v, do = _qkv(s, s)
    got, got_g = _port_value_and_grads(PORT[impl], q, k, v, do, causal)
    want, want_g = _jax_value_and_grads(JAX[impl], q, k, v, do, causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_several_padded_blocks_match_jax(causal):
    """S = 200 with blocks of 128: two k-blocks, the second padded, so the
    online recurrence and the key masking run on both sides."""
    q, k, v, do = _qkv(7, 200)
    got, got_g = _port_value_and_grads(
        lambda *a, causal: fa.flash_attention(*a, causal=causal, block_q=128, block_k=128),
        q, k, v, do, causal,
    )
    want, want_g = _jax_value_and_grads(
        lambda *a, causal: jax_flash(*a, causal=causal, block_q=128, block_k=128, interpret=True),
        q, k, v, do, causal,
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("s,block_k,causal", [(200, 128, False), (200, 64, True), (37, 16, True)])
def test_blocked_backward_matches_autograd(s, block_k, causal):
    """The port's blocked backward from the saved logsumexp against autograd
    through ``full_attention``: the same gradients for any block size."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(11, s))
    out, lse = fa.flash_forward_reference(q, k, v, causal)
    got = fa.flash_backward(q, k, v, out, lse, do, causal, block_k)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    full_attention(*leaves, causal=causal).backward(do)
    for name, a, b in zip("qkv", got, leaves):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


def test_flash_lse_is_the_rows_logsumexp():
    """The plain forward's lse is logsumexp over each row's scaled, masked
    scores, laid out [B, H, S]."""
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(12, 40))
    _, lse = fa.flash_forward_reference(q, k, v, causal=True)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * D**-0.5, k)
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (B, H, 40) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_fused_small_outside_the_envelope_is_full_attention():
    """At S = 196 (vit_s16 at 224 px) the tiny-S function is
    ``full_attention`` on both sides: same bits as the port's
    ``full_attention``, no kernel autograd node, and the JAX function's
    values."""
    q, k, v, do = _qkv(13, 196)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fas.fused_attention_small(qt, kt, vt)
    assert "FusedSmall" not in type(out.grad_fn).__name__
    assert torch.equal(out, full_attention(qt, kt, vt))
    want = jax_fused_small(*map(jnp.asarray, (q, k, v)), interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_fused_small_backward_reference_matches_jax_kernel():
    """The plain version of the tiny-S backward (the kernel's order:
    normalized p, recomputed o, Δ = Σ do·o) against ``jax.vjp`` through
    the Pallas kernel, causal and at a padded S."""
    q, k, v, do = _qkv(14, 50)
    got = fas.attention_small_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, do)), causal=True)
    _, want = _jax_value_and_grads(JAX["fused-small"], q, k, v, do, True)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-5, atol=5e-5, err_msg=f"d{name}")


def test_cpu_tensors_launch_nothing():
    """The wrappers run their plain versions for CPU tensors, in bf16 too,
    and the kernels' launch counts do not move."""
    counters = (fas.forward_tc_counter, fas.forward_tc_f32_counter, fas.forward_ffma_counter,
                fas.backward_tc_counter, fas.backward_tc_pad_counter, fas.backward_tc_f32_counter,
                fa.tc_counter, fa.tc_pad_counter, fa.tc_f32_counter)
    before = [c.count for c in counters]
    for d in (D, 40):
        q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(15, 64, d))
        for fn in (fas.fused_attention_small, fa.flash_attention):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            assert out.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in leaves)
            torch.testing.assert_close(out, full_attention(q, k, v), rtol=0, atol=0)
    assert [c.count for c in counters] == before


def test_operand_checks():
    q = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="one \\[B, S, H, D\\] shape"):
        fas.fused_attention_small(q, q, q[:, :4])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(*(q.to("meta"),) * 3)
