"""The walk of the stem's training forward (K2) on the CPU, against its plain
version and the JAX package's Pallas forward.

``stem_pool_argmax_band_kernel`` (``csrc/fused_stem.cu``) folds one tile
at a time: an image, a band of R output rows, a block of TW output columns
and a slice of CS channels. Tiles are numbered band fastest and each CTA
takes one contiguous run of them. A tile's stage holds its input rows
2·oh0 … 2·(oh0 + R) − 1 and columns 2·ow0 − 1 … 2·(ow0 + TW) − 1, clipped
to the grid; the band's top row 2·oh0 − 1 is the band above's bottom row,
whose column fold the CTA carries from the tile before, and is staged (the
halo row) only for the first tile of a run. The row above and the column
left of the grid are padding, −inf by coordinate and never staged. The
affine and relu run once per staged element; each input row folds over dw
at the even centres, then each output row over dh, both in
``_pool_argmax_t``'s order (strict ``>`` for the index, NaN-propagating
max for the value). No CUDA kernel runs here, so :func:`band_walk` walks
the same tiles and runs in torch and is held to:

- the plain version ``stem_pool_argmax_reference``: pooled bit for bit,
  k equal on every window whose max is finite;
- the JAX ``_fwd_impl(want_idx=True)`` in Pallas interpret mode, in its
  [H, W, C, B] layout as ``tests/test_torch_stem_train.py`` runs it: k
  exactly equal on finite windows, pooled within atol 1e-6 (JAX may fuse
  ``y·a + b`` into one multiply-add: a few f32 ulps);

on random, tie-heavy (with a NaN) and all-relu-zero inputs (b ≪ 0, so
every window ties at 0), at H = W = 2, with a short last band (H/2 not a
multiple of R), W/2 odd with a short last column block, channel slices,
whole-row bands, runs that start inside an image (a staged halo row) and
one run over everything (every top row carried). A walk that fills the
padding with zeros, as a copy's out-of-bounds fill would, moves k: that
pins why the kernel masks by coordinate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops import fused_stem as jax_fs
from mpi_pytorch_tpu_torch.ops import fused_stem as port

# (shape [B, H, W, C], R, TW, CS, CTAs): the tile geometry and runs walked.
GEOMETRIES = {
    "whole_rows": ((4, 16, 16, 64), 2, 8, 64, 5),  # one copy a band, as the training shape
    "short_band": ((2, 14, 12, 64), 3, 6, 64, 4),  # H/2 = 7: bands 3, 3, 1
    "odd_w2_col_blocks": ((2, 6, 10, 64), 2, 2, 32, 5),  # W/2 = 5: blocks 2, 2, 1; two slices
    "h2_w2": ((4, 2, 2, 64), 1, 1, 64, 3),  # one window a row and column
    "channel_slices": ((2, 8, 8, 256), 2, 4, 64, 7),  # four slices, two column blocks
    "one_run": ((2, 14, 12, 64), 1, 6, 64, 1),  # every top row carried, across images
}
KINDS = ["random", "tie_heavy", "relu_zero"]


def _column_fold(z, cols: int):
    """(v, dw) of each row of z [rows, 2·cols + 1, cs] at the centres
    1, 3, …: over dw = 0, 1, 2, strict > for dw, NaN-propagating max."""
    zl, zc, zr = (z[:, d : d + 2 * cols : 2] for d in range(3))
    dw = torch.where(zc > zl, 1, 0).to(torch.int8)
    v = torch.maximum(zl, zc)
    dw = torch.where(zr > v, 2, dw).to(torch.int8)
    return torch.maximum(v, zr), dw


def band_walk(y, a, b, r: int, tw: int, cs: int, ctas: int, zero_fill: bool = False):
    """(pooled in y's dtype, k int8) as the band kernel walks its tiles,
    ``ctas`` runs of them. With ``zero_fill`` the padding row and column
    take the value a zero input would (relu(0·a + b)) instead of −inf."""
    bsz, h, w, c = y.shape
    h2, w2 = h // 2, w // 2
    n_band, n_cb, n_sl = -(-h2 // r), -(-w2 // tw), c // cs
    tiles = bsz * n_sl * n_cb * n_band
    pooled = torch.empty((bsz, h2, w2, c), dtype=torch.float32)
    k = torch.empty((bsz, h2, w2, c), dtype=torch.int8)
    for cta in range(ctas):
        first, last = cta * tiles // ctas, (cta + 1) * tiles // ctas
        top = None  # the carried column fold of the band's top row
        for tile in range(first, last):
            t, band = divmod(tile, n_band)
            t, cb = divmod(t, n_cb)
            n, sl = divmod(t, n_sl)
            oh0, ow0, c0 = band * r, cb * tw, sl * cs
            rows, cols = min(r, h2 - oh0), min(tw, w2 - ow0)
            sa, sb = a[c0 : c0 + cs].float(), b[c0 : c0 + cs].float()
            pad = torch.relu(0.0 * sa + sb) if zero_fill else torch.full((cs,), float("-inf"))
            halo = tile == first and oh0 > 0
            gr0 = 2 * oh0 - 1 if halo else 2 * oh0
            gc0, gc1 = max(2 * ow0 - 1, 0), 2 * (ow0 + cols)
            # The stage: what the clipped copies bring, its affine once.
            z = torch.relu(y[n, gr0 : 2 * (oh0 + rows), gc0:gc1, c0 : c0 + cs].float() * sa + sb)
            if ow0 == 0:  # the column left of the grid, by coordinate
                z = torch.cat([pad.expand(z.shape[0], 1, cs), z], dim=1)
            v, dw = _column_fold(z, cols)
            if oh0 == 0:  # the row above the grid, by coordinate
                top = _column_fold(pad.expand(1, 2 * cols + 1, cs), cols)
            elif halo:
                top = (v[:1], dw[:1])
                v, dw = v[1:], dw[1:]
            # else: carried from the tile before, the band above
            assert top is not None
            v, dw = torch.cat([top[0], v]), torch.cat([top[1], dw])
            # The row fold over dh: output row i from rows 2i, 2i + 1, 2i + 2.
            (tv, mv, bv), (tk, mk, bk) = (
                [t_[d : d + 2 * rows : 2] for d in range(3)] for t_ in (v, dw)
            )
            kk = torch.where(mv > tv, 3 + mk, tk)
            m = torch.maximum(tv, mv)
            kk = torch.where(bv > m, 6 + bk, kk)
            m = torch.maximum(m, bv)
            pooled[n, oh0 : oh0 + rows, ow0 : ow0 + cols, c0 : c0 + cs] = m
            k[n, oh0 : oh0 + rows, ow0 : ow0 + cols, c0 : c0 + cs] = kk
            top = (v[-1:], dw[-1:])  # the band's bottom row: the next band's top
    return pooled.to(y.dtype), k


def _inputs(seed: int, shape, kind: str):
    """(y, a, b) f32 from a numpy seed: y normal, or coarse integers with
    one NaN (most windows tie), and b ≪ 0 for all-relu-zero."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    if kind == "tie_heavy":
        y = rng.integers(-2, 3, size=shape).astype(np.float32)
        y[0, shape[1] // 2, shape[2] - 1, 3] = np.nan
    else:
        y = rng.normal(size=shape).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(c,)).astype(np.float32)
    if kind == "relu_zero":
        b = np.full((c,), -1e3, dtype=np.float32)
    return tuple(torch.from_numpy(t) for t in (y, a, b))


def _jax_forward(y, a, b):
    """The Pallas training forward (interpret mode) in its [H, W, C, B]
    layout: (pooled, k) [B, H/2, W/2, C] as numpy."""
    yt = jnp.transpose(jnp.asarray(y.numpy()), (1, 2, 3, 0))
    p, k = jax_fs._fwd_impl(yt, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), want_idx=True,
                            interpret=True)
    p = np.transpose(np.asarray(p), (3, 0, 1, 2))
    k = np.transpose(np.asarray(k.astype(jnp.float32)), (3, 0, 1, 2)).astype(np.int8)
    return p, k


def _assert_matches_reference(pooled, k, ref_p, ref_k):
    nan = torch.isnan(ref_p)
    assert torch.equal(torch.isnan(pooled), nan)
    assert torch.equal(pooled[~nan], ref_p[~nan])
    assert torch.equal(k[~nan], ref_k[~nan])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_band_walk_matches_reference_and_pallas(geometry, kind):
    shape, *walk = GEOMETRIES[geometry]
    y, a, b = _inputs(40 + list(GEOMETRIES).index(geometry) * 3 + KINDS.index(kind), shape, kind)
    pooled, k = band_walk(y, a, b, *walk)
    _assert_matches_reference(pooled, k, *port.stem_pool_argmax_reference(y, a, b))
    jax_p, jax_k = _jax_forward(y, a, b)
    fin = ~np.isnan(jax_p)
    np.testing.assert_array_equal(np.isnan(pooled.numpy()), ~fin)
    np.testing.assert_array_equal(k.numpy()[fin], jax_k[fin])
    np.testing.assert_allclose(pooled.numpy()[fin], jax_p[fin], rtol=0, atol=1e-6)
    if kind == "relu_zero":  # every window ties at 0: k is its first in-grid element
        assert float(pooled.abs().max()) == 0.0
        assert bool((k[:, 0, 0] == 4).all()) and bool((k[:, 1:, 1:] == 0).all())
    if kind == "tie_heavy":  # the tie rule is really exercised
        assert (k != 4).float().mean() > 0.3


def test_band_walk_bf16_matches_reference():
    """In bf16, the training dtype, pooled is the plain version's bit for
    bit (the same f32 max, one rounding) and k equal."""
    shape, *walk = GEOMETRIES["short_band"]
    y, a, b = _inputs(60, shape, "random")
    y = y.to(torch.bfloat16)
    pooled, k = band_walk(y, a, b, *walk)
    assert pooled.dtype == torch.bfloat16
    _assert_matches_reference(pooled, k, *port.stem_pool_argmax_reference(y, a, b))


@pytest.mark.parametrize("kind", ["random", "relu_zero"])
def test_zero_filled_padding_moves_k(kind):
    """Padding filled with a zero input (relu(0·a + b)) instead of −inf:
    on random inputs relu(b) beats real elements of some edge windows;
    with every relu zero, the padding ties with them and, coming first in
    row-major order, takes k. The kernel masks by coordinate for this."""
    shape, *walk = GEOMETRIES["short_band"]
    y, a, b = _inputs(61, shape, kind)
    ref_p, ref_k = port.stem_pool_argmax_reference(y, a, b)
    pooled, k = band_walk(y, a, b, *walk, zero_fill=True)
    edge = torch.zeros(ref_k.shape, dtype=torch.bool)
    edge[:, 0], edge[:, :, 0] = True, True
    assert bool((k != ref_k)[edge].any())
    assert torch.equal(k[~edge], ref_k[~edge])  # only windows touching the padding move
    if kind == "relu_zero":
        assert bool((k[:, 0, 0] == 0).all())  # the padding corner, not element (0, 0)
    _assert_matches_reference(*band_walk(y, a, b, *walk), ref_p, ref_k)
