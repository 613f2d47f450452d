"""The arithmetic of the tensor-core attention forwards, on the CPU, against
the JAX package.

The bf16 route of K8 (``flash_forward``) and of K9's training forward
(``attention_small_forward(..., train=True)``) runs on Hopper's tensor cores (``csrc/attention_tc.cuh``): the scores are
exact bf16 products summed in f32, scaled afterwards; p = 2^((s − m)·log2
e) as the hardware's base-2 exponential takes it; the f32 p splits
into three bf16 terms (t0 = bf16(p), t1 = bf16(p − t0), t2 = bf16(p − t0
− t1)), each times the bf16 v an exact product, summed in f32; the output
is that sum ÷ l. No CUDA kernel runs here, so a torch emulation of those
numerics (``ops/attention_split_numerics.py``) — whole-row for K9, key
blocks of 64 with the online recurrence for K8, as the kernels tile (the
kernel's narrower last block adds the same padded keys' exact zeros) — is
held against the JAX
``fused_attention_small`` and ``flash_attention`` kernels in Pallas
interpret mode, as their own tests run them, on numpy-seeded bf16 q, k, v
at vit_s16's shapes (H = 6, Dh = 64) with a small batch.

Tolerances:
- the bf16 output within one bf16 ulp (2^-7 relative, plus 1e-6) of the
  JAX kernel's bf16 output, the card's check of the kernels: both round
  f32 values that differ by ~1e-7 of the output's scale;
- the f32 output before rounding within 1e-5 relative (|a − b| ≤ 1e-5 ·
  max|b|) of the JAX kernel run on the same values in f32: f32 sums in
  another order;
- K8's logsumexp within 1e-5 of the JAX kernel's.
Two tests guard the split: a single bf16 p (t0 only, off by up to 2^-8)
misses the f32 tolerance by two orders of magnitude; two terms (p to
2^-17) stay inside it but cross the one-ulp check at outputs near zero, on
a seeded batch where three terms hold. The route rule itself (which
dtypes and head dims reach the tensor cores) is checked case by case; the
bf16 head dims that are not a multiple of 16 are held against the JAX
kernels in ``test_torch_attention_pad_tc.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.flash_attention import _fwd_impl as jax_flash_fwd
from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops import flash_attention as fa
from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import emulate_flash_bf16 as emulate_flash
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import emulate_small_bf16 as emulate_small

B, H, D = 2, 6, 64
F32_REL = 1e-5


def _qkv(seed: int, s: int, b: int = B) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, H, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _jax_small(q, k, v, causal: bool, dtype) -> np.ndarray:
    args = [jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, v)]
    return np.asarray(jax_fused_small(*args, causal=causal, interpret=True).astype(jnp.float32))


def _jax_flash(q, k, v, causal: bool, dtype) -> tuple[np.ndarray, np.ndarray]:
    """The JAX flash forward (``_fwd_impl``, blocks of 128 as its wrapper
    cuts S ≥ 128) in interpret mode: (out [B, S, H, D], lse [B, H, S])."""
    s = q.shape[1]
    blk = min(128, max(8, s))
    to3 = lambda t: jnp.asarray(t.float().numpy()).astype(dtype).transpose(0, 2, 1, 3).reshape(B * H, s, D)  # noqa: E731
    out, lse = jax_flash_fwd(to3(q), to3(k), to3(v), causal=causal, block_q=blk, block_k=blk,
                             interpret=True)
    out = np.asarray(out.astype(jnp.float32)).reshape(B, H, s, D).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :s].reshape(B, H, s)


def _ulp_ratio(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest |got − want| of the bf16 outputs over the one-ulp
    tolerance (2^-7·max(|got|, |want|) + 1e-6): ≤ 1 passes."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((np.abs(g - want) / (2.0**-7 * np.maximum(np.abs(g), np.abs(want)) + 1e-6)).max())


def _f32_gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got − want| over max |want|: the relative gap the tolerance
    bounds."""
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


SMALL_CASES = [(64, False), (65, False), (64, True)]
FLASH_CASES = [(64, False), (196, False), (65, False), (196, True)]
IDS = lambda cases: [f"s{s}{'_causal' if c else ''}" for s, c in cases]  # noqa: E731


@pytest.mark.parametrize("s,causal", SMALL_CASES, ids=IDS(SMALL_CASES))
def test_small_split_p_matches_jax(s, causal):
    q, k, v = _qkv(100 + s, s)
    got = emulate_small(q, k, v, causal)
    assert _ulp_ratio(got, _jax_small(q, k, v, causal, jnp.bfloat16)) <= 1
    assert _f32_gap(got, _jax_small(q, k, v, causal, jnp.float32)) <= F32_REL


@pytest.mark.parametrize("s,causal", FLASH_CASES, ids=IDS(FLASH_CASES))
def test_flash_split_p_matches_jax(s, causal):
    q, k, v = _qkv(200 + s, s)
    got, lse = emulate_flash(q, k, v, causal)
    assert _ulp_ratio(got, _jax_flash(q, k, v, causal, jnp.bfloat16)[0]) <= 1
    want, want_lse = _jax_flash(q, k, v, causal, jnp.float32)
    assert _f32_gap(got, want) <= F32_REL
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["small", "flash"])
def test_a_single_bf16_p_breaks_the_f32_tolerance(kernel):
    """t0 alone (a bf16 p) is a different function: its gap to the f32 JAX
    kernel is over ten times the tolerance the three terms keep."""
    q, k, v = _qkv(300, 64)
    if kernel == "small":
        want = _jax_small(q, k, v, False, jnp.float32)
        split, single = (emulate_small(q, k, v, False, terms=t) for t in (3, 1))
    else:
        want = _jax_flash(q, k, v, False, jnp.float32)[0]
        split, single = (emulate_flash(q, k, v, False, terms=t)[0] for t in (3, 1))
    assert _f32_gap(split, want) <= F32_REL
    assert _f32_gap(single, want) > 10 * F32_REL


def test_two_terms_cross_the_one_ulp_check():
    """Why three terms: on this seeded [32, 64, 6, 64] batch two terms (p
    to 2^-17) put outputs near zero more than one bf16 ulp plus 1e-6 from
    the JAX kernel's; three terms hold every element."""
    q, k, v = _qkv(3, 64, b=32)
    args = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)]
    want = np.asarray(jax_fused_small(*args, interpret=True).astype(jnp.float32))
    assert _ulp_ratio(emulate_small(q, k, v, False, terms=2), want) > 1
    assert _ulp_ratio(emulate_small(q, k, v, False, terms=3), want) <= 1


@pytest.mark.parametrize(
    "dtype,d,forward,backward",
    [
        (torch.bfloat16, 64, "tensor_core", "tensor_core"),
        (torch.bfloat16, 16, "tensor_core", "tensor_core"),
        (torch.bfloat16, 48, "tensor_core", "tensor_core"),
        (torch.bfloat16, 128, "tensor_core", "tensor_core"),
        (torch.bfloat16, 8, "ffma", "tensor_core"),
        (torch.bfloat16, 36, "ffma", "tensor_core"),
        (torch.bfloat16, 144, "ffma", "ffma"),
        (torch.float32, 64, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 16, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 36, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 128, "tensor_core_f32", "tensor_core_f32"),
    ],
)
def test_route(dtype, d, forward, backward):
    """``backward``: the rule as :func:`_build.attention_route` states it,
    which K8's flash forward and K10's backward take as it is: bf16 with
    any D % 4 == 0 up to 128 reaches the bf16 tensor cores (a D that is not
    a multiple of 16 zero-padded to the next one), f32 with any such D the
    f32 tensor-core kernels. ``forward``: the tiny-S forward's training
    route, which keeps the FFMA kernel for a bf16 D that is not a multiple
    of 16; its f32 inference calls take the f32 tensor cores too, and its
    bf16 inference calls keep the FFMA kernel."""
    assert _build.attention_route(dtype, d) == backward
    assert fas._route(dtype, d, train=True) == forward
    assert fas._route(dtype, d, train=False) == ("ffma" if dtype == torch.bfloat16 else forward)


def test_cpu_tensors_count_no_route():
    """On CPU tensors the forwards run their plain versions on every
    route's inputs, and no route's launch count moves."""
    counters = (fa.tc_counter, fa.tc_pad_counter, fa.tc_f32_counter, fas.forward_tc_counter,
                fas.forward_tc_f32_counter, fas.forward_ffma_counter)
    before = [c.count for c in counters]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in _qkv(400, 64))
        for train in (True, False):
            fas.attention_small_forward(q, k, v, train=train)
        fa.flash_forward(q, k, v)
    assert [c.count for c in counters] == before
