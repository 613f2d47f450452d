"""The bf16 tensor-core attention kernels at head dims that are not a
multiple of 16, on the CPU, against the JAX package.

K8's bf16 forward (``flash_fwd_tc_kernel``) and K10's bf16 backward
(``attn_small_bwd_tc_kernel``) take any D % 4 == 0 up to 128: each is
instantiated per DK = D rounded up to 16 (the k-steps of q·kᵀ and do·vᵀ)
and stages q, k, v and do with their columns D..DK−1 zero, written at every
load; only the first D columns of the outputs are stored. No CUDA kernel
runs here, so the torch emulations of their arithmetic
(``ops/attention_split_numerics.py``: exact bf16 score products summed in
f32, p and ds as three bf16 terms) run on inputs zero-padded to DK as the
kernels stage them, and their first D columns are held against the JAX
``flash_attention`` forward and ``jax.vjp`` through the JAX
``fused_attention_small``, both in Pallas interpret mode as their own
tests run them, on numpy-seeded bf16 inputs at D = 40, 36 and 8 (padded to
48, 48 and 16), causal and not, at S that pad the kernels' key blocks.

Tolerances, those of ``test_torch_attention_tc.py`` and
``test_torch_attention_bwd_tc.py``:
- the forward's output within one bf16 ulp (2^-7 relative, plus 1e-6) of
  the JAX kernel's bf16 output, within 1e-5 · max|reference| of the JAX
  kernel run in f32, and its logsumexp within 1e-5;
- the gradients within 1e-5 · max|reference| of the f32 ``jax.vjp``, and
  bf16-rounded within the card's check (one bf16 ulp plus 1e-4 of the
  largest magnitude).
One test pins the padding rule: zero padding columns change no bit of
the first D columns, and stale ones (finite values in both q and k, or in
both v and do; a NaN in v's alone) do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.flash_attention import _fwd_impl as jax_flash_fwd
from mpi_pytorch_tpu.ops.fused_attention_small import fused_attention_small as jax_fused_small
from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
    emulate_flash_bf16,
    emulate_small_backward_bf16,
    pad_head,
)

B, H = 2, 3
F32_REL = 1e-5
# (D, S, causal): D % 8 == 0 (16-byte rows), D % 8 == 4 (8-byte rows), the
# narrowest head; S past one key block and a 64-key block boundary.
FLASH_CASES = [(40, 196, False), (40, 65, True), (36, 196, True), (36, 65, False), (8, 130, False),
               (8, 64, True)]
BWD_CASES = [(40, 64, False), (40, 65, True), (36, 50, False), (36, 64, True), (8, 128, False),
             (8, 50, True)]
IDS = lambda cases: [f"d{d}_s{s}{'_causal' if c else ''}" for d, s, c in cases]  # noqa: E731


def _dk(d: int) -> int:
    return -(-d // 16) * 16


def _inputs(seed: int, s: int, d: int, n: int) -> list[torch.Tensor]:
    """n tensors [B, S, H, d]: numpy-seeded normals rounded to bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(n)]


def _padded(ts, d: int) -> list[torch.Tensor]:
    return [pad_head(t, _dk(d)) for t in ts]


def _jax_flash(q, k, v, causal: bool, dtype) -> tuple[np.ndarray, np.ndarray]:
    """The JAX flash forward (``_fwd_impl``, blocks as its wrapper cuts
    them) in interpret mode: (out [B, S, H, D], lse [B, H, S])."""
    b, s, h, d = q.shape
    blk = min(128, max(8, s))
    to3 = lambda t: jnp.asarray(t.float().numpy()).astype(dtype).transpose(0, 2, 1, 3).reshape(b * h, s, d)  # noqa: E731
    out, lse = jax_flash_fwd(to3(q), to3(k), to3(v), causal=causal, block_q=blk, block_k=blk,
                             interpret=True)
    out = np.asarray(out.astype(jnp.float32)).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :s].reshape(b, h, s)


def _jax_grads(q, k, v, do, causal: bool) -> list[np.ndarray]:
    """``jax.vjp`` through the JAX tiny-S kernel (interpret mode) on the
    same values in f32: (dq, dk, dv)."""
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: jax_fused_small(*a, causal=causal, interpret=True), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do.float().numpy()))]


def _ulp_ratio(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest |bf16(got) − want| over one bf16 ulp plus 1e-6: ≤ 1
    passes."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((np.abs(g - want) / (2.0**-7 * np.maximum(np.abs(g), np.abs(want)) + 1e-6)).max())


def _grad_check_ratio(got: torch.Tensor, want: np.ndarray) -> float:
    """The largest |bf16(got) − want| over the card's tolerance, 2^-7·|want|
    + 1e-4·max|want|: ≤ 1 passes."""
    g = got.to(torch.bfloat16).float().numpy()
    return float((np.abs(g - want) / (2.0**-7 * np.abs(want) + 1e-4 * np.abs(want).max())).max())


def _f32_gap(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got − want| over max |want|."""
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d,s,causal", FLASH_CASES, ids=IDS(FLASH_CASES))
def test_padded_flash_forward_matches_jax(d, s, causal):
    q, k, v = _inputs(800 + d + s, s, d, 3)
    out, lse = emulate_flash_bf16(*_padded((q, k, v), d), causal, d=d)
    got = out[..., :d]
    assert _ulp_ratio(got, _jax_flash(q, k, v, causal, jnp.bfloat16)[0]) <= 1
    want, want_lse = _jax_flash(q, k, v, causal, jnp.float32)
    assert _f32_gap(got, want) <= F32_REL
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,s,causal", BWD_CASES, ids=IDS(BWD_CASES))
def test_padded_backward_matches_jax(d, s, causal):
    q, k, v, do = _inputs(900 + d + s, s, d, 4)
    grads = emulate_small_backward_bf16(*_padded((q, k, v, do), d), causal, d=d)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, _jax_grads(q, k, v, do, causal)):
        assert _f32_gap(got[..., :d], ref) <= F32_REL, name
        assert _grad_check_ratio(got[..., :d], ref) <= 1, name


@pytest.mark.parametrize("stale", ["q_and_k", "v_and_do", "nan_in_v"])
def test_padding_columns_must_be_zero(stale):
    """Zero padding columns leave the first D columns of the forward's
    output and lse, and of every gradient, bit for bit those of the
    unpadded emulation at D = 40. Stale padding breaks them: finite values
    in both q and k change the scores; in both v and do they change dp =
    do·vᵀ, so Δ and ds (values that differ from key to key: a constant
    shift of dp would cancel in ds); a NaN in v's padding alone, against
    do's zeros, makes every gradient NaN."""
    d, s = 40, 65
    q, k, v, do = _inputs(1000, s, d, 4)
    fwd, lse = emulate_flash_bf16(q, k, v)
    bwd = emulate_small_backward_bf16(q, k, v, do)
    padded = _padded((q, k, v, do), d)
    out_p, lse_p = emulate_flash_bf16(*padded[:3], d=d)
    assert torch.equal(out_p[..., :d], fwd) and torch.equal(lse_p, lse)
    assert all(torch.equal(g[..., :d], r) for g, r in zip(emulate_small_backward_bf16(*padded, d=d), bwd))

    rng = np.random.default_rng(1001)
    junk = lambda: torch.from_numpy(rng.standard_normal((B, s, H, _dk(d) - d)).astype(np.float32))  # noqa: E731
    if stale == "q_and_k":
        qp, kp = (pad_head(t, _dk(d), junk()) for t in (q, k))
        out = emulate_flash_bf16(qp, kp, padded[2], d=d)[0][..., :d]
        assert _f32_gap(out, fwd.numpy()) > 100 * F32_REL
    else:
        if stale == "v_and_do":
            vp, dop = (pad_head(t, _dk(d), junk()) for t in (v, do))
        else:
            vp, dop = pad_head(v, _dk(d), float("nan")), padded[3]
        grads = emulate_small_backward_bf16(padded[0], padded[1], vp, dop, d=d)
        dq, dk = (g[..., :d] for g in grads[:2])
        if stale == "v_and_do":
            assert min(_f32_gap(dq, bwd[0].numpy()), _f32_gap(dk, bwd[1].numpy())) > 100 * F32_REL
            assert torch.equal(grads[2][..., :d], bwd[2])  # dv = pᵀ·do reads no padding
        else:
            assert all(bool(torch.isnan(g[..., :d]).all()) for g in grads[:2])


@pytest.mark.parametrize("d", range(4, 129, 4))
def test_every_bf16_head_dim_takes_the_tensor_cores(d):
    """K8 and K10 take bf16 on the tensor cores at every D % 4 == 0 up to
    128; the tiny-S forward's training calls only at D % 16 == 0 (its
    padded route is not built), its inference calls never."""
    assert _build.attention_route(torch.bfloat16, d) == "tensor_core"
    assert fas._route(torch.bfloat16, d, train=True) == ("tensor_core" if d % 16 == 0 else "ffma")
    assert fas._route(torch.bfloat16, d, train=False) == "ffma"
