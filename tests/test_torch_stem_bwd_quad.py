"""The walk of the stem's index backward (K3) on the CPU, against its plain
version and the JAX package's Pallas backward.

``stem_pool_bwd_kernel`` (``csrc/fused_stem.cu``) is a quad gather: one
thread per window (b, oh, ow) and 8 channels writes the 2×2 inputs (2oh,
2oh+1) × (2ow, 2ow+1), each from fixed window offsets in a fixed order —
(even, even) window (oh, ow) at k = 4; (even, odd) (oh, ow) at 5, then
(oh, ow+1) at 3; (odd, even) (oh, ow) at 7, then (oh+1, ow) at 1; (odd,
odd) (oh, ow) at 8, (oh, ow+1) at 6, (oh+1, ow) at 2, (oh+1, ow+1) at 0 —
where a window right of or below the grid adds nothing. No CUDA kernel runs
here, so :func:`quad_gather` walks the same way in torch (per parity, the
fixed offsets in the fixed order), and is held to dy bit for bit against
``stem_pool_backward_reference`` and against the JAX ``_bwd_impl`` in
Pallas interpret mode (on the same g, k and pooled, in f32, in the JAX
kernel's [H, W, C, B] layout, as ``tests/test_torch_stem_train.py`` runs
it), at the training layout (NHWC, C = 64) and at edge shapes: H = W = 2
(no window right of or below any quad) and odd H/2, W/2. da and db are
sums over the batch in another order: rtol 1e-5 plus atol 1e-5 for
channels whose sum cancels near zero, as the stem's other tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops import fused_stem as jax_fs
from mpi_pytorch_tpu_torch.ops import fused_stem as port

SHAPES = [(8, 16, 16, 64), (4, 2, 2, 64), (4, 6, 10, 64)]
IDS = ["train_layout", "h2_w2", "odd_windows"]


def quad_gather(g, k, pooled, y, a):
    """(dy in y's dtype, da, db) as the kernel walks: each window's masked
    gradient routed to the 2×2 inputs of its quad by the fixed offsets, in
    the kernel's order; the window right of (below) a quad only where one
    exists."""
    gm = torch.where(pooled.float() > 0, g.float(), 0.0)  # [B, H2, W2, C]

    def sel(view_k, view_g, want):
        return torch.where(view_k == want, view_g, 0.0)

    ee = torch.zeros_like(gm) + sel(k, gm, 4)
    eo = torch.zeros_like(gm) + sel(k, gm, 5)
    oe = torch.zeros_like(gm) + sel(k, gm, 7)
    oo = torch.zeros_like(gm) + sel(k, gm, 8)
    eo[:, :, :-1] += sel(k[:, :, 1:], gm[:, :, 1:], 3)  # window (oh, ow+1)
    oo[:, :, :-1] += sel(k[:, :, 1:], gm[:, :, 1:], 6)
    oe[:, :-1] += sel(k[:, 1:], gm[:, 1:], 1)  # window (oh+1, ow)
    oo[:, :-1] += sel(k[:, 1:], gm[:, 1:], 2)
    oo[:, :-1, :-1] += sel(k[:, 1:, 1:], gm[:, 1:, 1:], 0)  # window (oh+1, ow+1)
    bsz, h2, w2, c = gm.shape
    du = torch.empty((bsz, 2 * h2, 2 * w2, c))
    du[:, 0::2, 0::2], du[:, 0::2, 1::2], du[:, 1::2, 0::2], du[:, 1::2, 1::2] = ee, eo, oe, oo
    dy = (du * a.float()).to(y.dtype)
    return dy, (du * y.float()).sum(dim=(0, 1, 2)), du.sum(dim=(0, 1, 2))


def _case(seed: int, shape, tie_heavy: bool):
    """(g, k, pooled, y, a) f32: y (coarse integers when tie-heavy, so most
    windows hold ties and k takes every offset), the plain training
    forward's pooled and k, and g, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    y = (rng.integers(-2, 3, size=shape) if tie_heavy else rng.normal(size=shape)).astype(np.float32)
    c = shape[-1]
    a = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(c,)).astype(np.float32)
    ty, ta, tb = (torch.from_numpy(t) for t in (y, a, b))
    pooled, k = port.stem_pool_argmax_reference(ty, ta, tb)
    g = torch.from_numpy(rng.normal(size=tuple(pooled.shape)).astype(np.float32))
    return g, k, pooled, ty, ta


def _jax_backward(g, k, pooled, y, a):
    """The JAX Pallas backward (interpret mode) on the same values, in its
    [H, W, C, B] layout: (dy [B, H, W, C], da, db) as numpy."""
    to_t = lambda t: jnp.transpose(jnp.asarray(t.numpy()), (1, 2, 3, 0))  # noqa: E731
    dyt, da, db = jax_fs._bwd_impl(to_t(g), to_t(k), to_t(pooled), to_t(y), jnp.asarray(a.numpy()),
                                  interpret=True)
    return np.transpose(np.asarray(dyt), (3, 0, 1, 2)), np.asarray(da), np.asarray(db)


@pytest.mark.parametrize("tie_heavy", [False, True], ids=["random", "tie_heavy"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_quad_walk_matches_reference_and_pallas(shape, tie_heavy):
    args = _case(20 + 2 * SHAPES.index(shape) + tie_heavy, shape, tie_heavy)
    dy, da, db = quad_gather(*args)
    ref_dy, ref_da, ref_db = port.stem_pool_backward_reference(*args)
    jax_dy, jax_da, jax_db = _jax_backward(*args)
    assert torch.equal(dy, ref_dy)
    np.testing.assert_array_equal(dy.numpy(), jax_dy)
    for got, want in ((da, ref_da), (db, ref_db), (da, jax_da), (db, jax_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert dy.abs().max() > 0


def test_quad_walk_bf16_matches_reference():
    """In bf16 (the training dtype) the walk's dy is the plain version's,
    bit for bit: the same f32 sums, then one rounding."""
    g, k, pooled, y, a = _case(30, SHAPES[0], False)
    args = (g.to(torch.bfloat16), k, pooled.to(torch.bfloat16), y.to(torch.bfloat16), a)
    assert torch.equal(quad_gather(*args)[0], port.stem_pool_backward_reference(*args)[0])


def test_every_window_offset_is_routed():
    """The tie-heavy case reaches all nine offsets, and each of a quad's
    inputs gets a gradient from a window other than its own somewhere: the
    walk's neighbour windows are exercised."""
    g, k, pooled, y, a = _case(31, SHAPES[0], True)
    assert set(torch.unique(k).tolist()) == set(range(9))
    gm = torch.where(pooled > 0, g, 0.0)
    for want, (di, dj) in ((3, (0, 1)), (1, (1, 0)), (0, (1, 1))):
        hit = (k[:, di:, dj:] == want) & (gm[:, di:, dj:] != 0)
        assert bool(hit.any()), want
