"""The port's fused stem (``mpi_pytorch_tpu_torch/ops/fused_stem.py``)
against the JAX package's Pallas kernel run in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel it stands for is held against the same plain version on the card by
``chip_smoke.py``. Inputs are made from a seed with numpy and handed to
both sides.

Tolerance: f32 atol 1e-6. The port's plain version and the Pallas
interpreter both compute ``y·a + b`` in f32 but may round it differently
(one fused multiply-add against a multiply then an add): the gap measured
at [8, 16, 16, 64] is 4.8e-7. bf16 outputs may then differ by one bf16
ulp where that gap moves a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_stem import stem_affine_relu_pool as jax_stem
from mpi_pytorch_tpu_torch.ops import fused_stem as port

SHAPE = (8, 16, 16, 64)


def _inputs(seed: int, shape=SHAPE, quantised: bool = False):
    rng = np.random.default_rng(seed)
    if quantised:
        # Values on a coarse grid: most 3×3 windows hold ties.
        y = rng.integers(-2, 3, size=shape).astype(np.float32)
    else:
        y = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    a = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(c,)).astype(np.float32)
    return y, a, b


def _run_both(y, a, b, dtype):
    jy = jnp.asarray(y).astype({"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    ty = torch.from_numpy(y).to({"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
    ref = jax_stem(jy, jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = port.stem_affine_relu_pool(ty, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == ty.dtype and tuple(got.shape) == tuple(ref.shape)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("case", ["random", "tie_heavy"])
def test_plain_stem_matches_pallas_f32(case):
    y, a, b = _inputs(1, quantised=case == "tie_heavy")
    ref, got = _run_both(y, a, b, "f32")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "tie_heavy"])
def test_plain_stem_matches_pallas_bf16(case):
    y, a, b = _inputs(2, quantised=case == "tie_heavy")
    ref, got = _run_both(y, a, b, "bf16")
    # One bf16 ulp (2^-7 relative to the leading power of two) at most.
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp), np.max(np.abs(got - ref) / ulp)


def test_plain_stem_propagates_nan_like_pallas():
    y, a, b = _inputs(3, shape=(2, 8, 8, 8))
    y[0, 3, 4, 5] = np.nan
    ref, got = _run_both(y, a, b, "f32")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).sum() > 0
    mask = ~np.isnan(ref)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=0, atol=1e-6)


def test_stem_shape_guards():
    y = torch.zeros(2, 15, 16, 8)
    a = torch.ones(8)
    with pytest.raises(ValueError, match="even spatial"):
        port.stem_affine_relu_pool(y, a, a)
    with pytest.raises(ValueError, match="affine shape"):
        port.stem_affine_relu_pool(torch.zeros(2, 16, 16, 8), torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        port.stem_affine_relu_pool(torch.zeros(16, 16, 8), a, a)


def test_stem_wrapper_has_no_fallback_off_cpu():
    """A tensor on neither the CPU nor a card is refused: the plain version
    runs only for CPU tensors, and the launch count stays untouched."""
    before = port.counter.count
    y = torch.empty(2, 16, 16, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.stem_affine_relu_pool(y, torch.ones(8, device="meta"), torch.ones(8, device="meta"))
    port.stem_affine_relu_pool(torch.zeros(2, 16, 16, 8), torch.ones(8), torch.ones(8))
    assert port.counter.count == before
