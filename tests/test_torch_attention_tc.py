"""The arithmetic of the tensor-core attention forwards, on the CPU, against
the JAX package.

The bf16 route of K8 (``flash_forward``) and of K9's training forward
(``attention_small_forward(..., train=True)``) runs on Hopper's tensor cores (``csrc/attention_tc.cuh``): the scores are
exact bf16 products summed in f32, scaled afterwards; p = 2^((s − m)·log2
e) as the hardware's base-2 exponential takes it; the f32 p splits
into three bf16 terms (t0 = bf16(p), t1 = bf16(p − t0), t2 = bf16(p − t0
− t1)), each times the bf16 v an exact product, summed in f32; the output
is that sum ÷ l. No CUDA kernel runs here, so a test-only torch emulation
of those numerics — whole-row for K9, key blocks of 64 with the online
recurrence for K8, as the kernels tile (the kernel's narrower last block
adds the same padded keys' exact zeros) — is held against the JAX
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
dtypes and head dims reach the tensor cores) is checked case by case.
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

B, H, D = 2, 6, 64
NEG = -1e30  # the kernels' mask value
KEY_BLOCK = 64  # the flash kernel's k/v block
F32_REL = 1e-5
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _qkv(seed: int, s: int, b: int = B) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, H, D)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, H, S, S] f32: exact bf16 products summed in f32, then · scale;
    −1e30 past the diagonal when causal."""
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), NEG)
    return sc


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp as the kernels take it: 2^(x·log2 e), the product rounded to f32."""
    return torch.exp2(x * LOG2E)


def _pv(p: torch.Tensor, v: torch.Tensor, terms: int) -> torch.Tensor:
    """p [B, H, S, N] f32 times v [B, H, N, D] bf16 as the kernels take it:
    the first ``terms`` bf16 terms of p, each times v (exact products),
    summed in f32."""
    out, rest = 0.0, p
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out, rest = out + t @ v.float(), rest - t
    return out


def emulate_small(q, k, v, causal: bool, terms: int = 3) -> torch.Tensor:
    """K9's tensor-core arithmetic: whole-row softmax, out = (p·v) / l,
    f32 [B, S, H, D] before the bf16 rounding."""
    sc = _scores(q, k, causal)
    p = _exp(sc - sc.amax(-1, keepdim=True))
    return (_pv(p, v.transpose(1, 2), terms) / p.sum(-1, keepdim=True)).transpose(1, 2)


def emulate_flash(q, k, v, causal: bool, terms: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's tensor-core arithmetic: key blocks of 64 (the last padded with
    −1e30 keys and zero values), the online recurrence m, l, acc·α; out =
    acc / safe_l (f32 [B, S, H, D] before rounding) and lse = m + log(safe_l)
    [B, H, S]."""
    s = q.shape[1]
    n = -(-s // KEY_BLOCK) * KEY_BLOCK
    sc = torch.nn.functional.pad(_scores(q, k, causal), (0, n - s), value=NEG)
    vt = torch.nn.functional.pad(v.transpose(1, 2), (0, 0, 0, n - s))
    b = q.shape[0]
    m = torch.full((b, H, s, 1), NEG)
    l = torch.zeros((b, H, s, 1))
    acc = torch.zeros((b, H, s, D))
    for k0 in range(0, n, KEY_BLOCK):
        blk = sc[..., k0:k0 + KEY_BLOCK]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = _exp(blk - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _pv(p, vt[:, :, k0:k0 + KEY_BLOCK], terms)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / safe_l).transpose(1, 2), (m + torch.log(safe_l))[..., 0]


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
        (torch.bfloat16, 8, "ffma", "ffma"),
        (torch.bfloat16, 36, "ffma", "ffma"),
        (torch.bfloat16, 144, "ffma", "ffma"),
        (torch.float32, 64, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 16, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 36, "tensor_core_f32", "tensor_core_f32"),
        (torch.float32, 128, "tensor_core_f32", "tensor_core_f32"),
    ],
)
def test_route(dtype, d, forward, backward):
    """The forwards: bf16 with D % 16 == 0 and D ≤ 128 reaches the bf16
    tensor cores, f32 with any D % 4 == 0 up to 128 the f32 tensor-core
    kernels, any other bf16 D the FFMA kernels. The flash forward takes
    this rule as it is; the tiny-S forward takes it for its training
    forward and for f32 inference, and its bf16 inference calls keep the
    FFMA kernel. K10's backward takes the same rule: f32 reaches its f32
    tensor-core kernel too."""
    assert _build.attention_route(dtype, d) == forward
    assert _build.attention_route(dtype, d) == backward
    assert fas._route(dtype, d, train=True) == forward
    assert fas._route(dtype, d, train=False) == ("ffma" if forward == "tensor_core" else forward)


def test_cpu_tensors_count_no_route():
    """On CPU tensors the forwards run their plain versions on every
    route's inputs, and no route's launch count moves."""
    counters = (fa.tc_counter, fa.tc_f32_counter, fa.ffma_counter, fas.forward_tc_counter,
                fas.forward_tc_f32_counter, fas.forward_ffma_counter)
    before = [c.count for c in counters]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in _qkv(400, 64))
        for train in (True, False):
            fas.attention_small_forward(q, k, v, train=train)
        fa.flash_forward(q, k, v)
    assert [c.count for c in counters] == before
