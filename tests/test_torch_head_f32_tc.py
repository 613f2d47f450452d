"""K4's f32 route on the tensor cores (``head_predict_f32_kernel`` of
``csrc/head_predict_tc.cu``), held on the CPU against the JAX package.

A CUDA kernel cannot run here, so :func:`emulate_f32_head` repeats the
kernel's arithmetic in torch:

- the logits as the kernel forms them: feats and W each split into three
  bf16 terms, the six term pairs (i + j ≤ 2) summed smallest first in f32
  (``attention_split_numerics.split_product``, the f32 attention kernels'
  arithmetic), plus the f32 bias;
- its order of reduction: vocab splits of whole 128-row tiles (the
  wrappers' ``split_geometry`` with the kernel's row tile), in each split
  64 threads a batch row — thread (wg, w, g) holds vocab rows
  64wg + 16w + g and + 8 of every tile — each keeping an online state over
  its rows tile by tile (the larger of its two rows, the first on a tie;
  the running argmax moving only on a strictly larger max; the sum of
  ``exp2((x − m)·log2 e)``; the label's logit), then merged across g by a
  shuffle tree and across the eight warps in order, equal maxima going to
  the smaller column; then the splits merged one warp a row, as every head
  merges them (``test_torch_head_tc.emulate_tc_head``'s last step).

It is held against the JAX ``head_predict`` on f32 feats and W run as a
Pallas kernel in interpret mode, with exact ties at tile, split, thread,
lane, warp, warpgroup and ragged-tile boundaries.

Tolerances: predictions exact (ties are exact in both — identical W rows
and biases give identical logits — and no other row has a near tie at these
seeds); loss rtol 1e-5 with atol 1e-5 (both sides sum f32 terms in
different orders, the six pairs stand for the f32 product to ~2^-24
relative, and exp2 of a rounded product stands for exp). The float64 gap
of the logits (max |error| over max |logit|): six pairs within 1e-6, three
pairs (the control) beyond it — the three smaller pairs are part of the f32
function.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_head_ce import head_predict as jax_head_predict
from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh
from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
    SIX, THREE, relative_gap, split3, split_product,
)

CSRC = Path(__file__).resolve().parents[1] / "mpi_pytorch_tpu_torch" / "csrc"
LOG2E = np.float32(1.4426950408889634)
D, V = 64, 1000  # 7 whole tiles of 128 and a ragged one of 104
TILE = 128
# Gap of the logits to float64 that six pairs keep and three do not.
SIX_PAIR_GAP = 1e-6


def _constant(name: str) -> int:
    """A plain ``constexpr int`` of the kernel source."""
    src = (CSRC / "head_predict_tc.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def f32_rows(rows: int, d: int) -> int:
    """The f32 kernel's batch rows a CTA (its ``f32_rows``): 64 above
    B = 8 where two W stages fit beside 64 rows of feats terms, else 8."""
    limit, stage, most = _constant("kSmemLimit"), 128 * 128, _constant("kMaxStages")

    def stages(n):
        left = (limit - 1024 - 3 * -(-2 * d // 128) * n * 128 - 4 * n) // (stage + 16)
        return 0 if left < 2 else min(left, most)

    if rows > 8 and stages(64):
        return 64
    return 8 if stages(8) else 0


def f32_geometry(rows: int, d: int, vocab: int, num_sms: int) -> tuple[int, int]:
    return fh.split_geometry(rows, vocab, num_sms, f32_rows(rows, d), TILE, fh._TC_CTAS_PER_SM)


# ------------------------------------------------------------- emulation ---


def split_logits(feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pairs=SIX) -> torch.Tensor:
    """feats [B, D] · W [V, D]ᵀ + b as the kernel forms it: ``pairs`` of
    the three-term splits, smallest first, in f32."""
    return split_product("bd,vd->bv", feats, w, pairs) + b


def _merge(m, l, arg, pick, om, ol, oa, op):
    """Two states merged: the larger max wins, equal maxima go to the
    smaller column; l rescaled to the merged max."""
    mn = torch.maximum(m, om)
    mL = torch.where(mn == -math.inf, torch.zeros_like(mn), mn * LOG2E)
    scaled = l * torch.exp2(m * LOG2E - mL) + ol * torch.exp2(om * LOG2E - mL)
    l = torch.where(mn == -math.inf, l, scaled)
    arg = torch.where((om > m) | ((om == m) & (oa < arg)), oa, arg)
    return mn, l, arg, pick + op


def _split_state(logits, lab, v_begin, v_end):
    """The CTA's merged (m, l, arg, pick) [B] over vocab rows
    [v_begin, v_end) in the kernel's order."""
    rows, vocab = logits.shape
    theta = torch.arange(64)
    off = 64 * (theta // 32) + 16 * ((theta // 8) % 4) + theta % 8  # (wg, w, g) → first row
    m = torch.full((rows, 64), -math.inf)
    l = torch.zeros(rows, 64)
    arg = torch.zeros(rows, 64, dtype=torch.long)
    pick = torch.zeros(rows, 64)
    for n0 in range(v_begin, v_end, TILE):
        r0, r1 = n0 + off, n0 + off + 8
        x0 = torch.where(r0 < v_end, logits[:, r0.clamp(max=vocab - 1)], -math.inf)
        x1 = torch.where(r1 < v_end, logits[:, r1.clamp(max=vocab - 1)], -math.inf)
        up = x1 > x0
        mx = torch.where(up, x1, x0)
        arg = torch.where(mx > m, torch.where(up, r1, r0).expand(rows, -1), arg)
        mn = torch.maximum(m, mx)
        mL = torch.where(mn == -math.inf, torch.zeros_like(mn), mn * LOG2E)
        l = l * torch.exp2(m * LOG2E - mL) + torch.exp2(x0 * LOG2E - mL) + torch.exp2(x1 * LOG2E - mL)
        m = mn
        pick = pick + torch.where(lab[:, None] == r0, x0, 0.0) + torch.where(lab[:, None] == r1, x1, 0.0)
    for bit in (1, 2, 4):  # lanes xor 4, 8, 16: g xor 1, 2, 4
        o = theta ^ bit
        m, l, arg, pick = _merge(m, l, arg, pick, m[:, o], l[:, o], arg[:, o], pick[:, o])
    state = [t[:, 0] for t in (m, l, arg, pick)]
    for w in range(1, 8):  # the warps in order
        state = _merge(*state, *(t[:, 8 * w] for t in (m, l, arg, pick)))
    return state


def emulate_f32_head(logits, labels, n_split: int, tiles_per_split: int):
    """(loss, pred) of f32 ``logits`` [B, V] reduced in the f32 kernel's
    order (module docstring)."""
    rows, vocab = logits.shape
    lab = labels.long()
    parts = []
    for s in range(n_split):
        v_begin = s * tiles_per_split * TILE
        parts.append(_split_state(logits, lab, v_begin, min(vocab, v_begin + tiles_per_split * TILE)))
    # The merge kernel: lane s over splits s, s + 32, ...; then xor 16 … 1.
    M = torch.full((rows, 32), -math.inf)
    L = torch.zeros(rows, 32)
    A = torch.full((rows, 32), 2**31 - 1, dtype=torch.long)
    P = torch.zeros(rows, 32)
    for s, (ms, ls, args, picks) in enumerate(parts):
        lane = s % 32
        up = ms > M[:, lane]
        L[:, lane] = torch.where(up, L[:, lane] * torch.exp(M[:, lane] - ms) + ls,
                                 L[:, lane] + ls * torch.exp(ms - M[:, lane]))
        A[:, lane] = torch.where(up, args, A[:, lane])
        M[:, lane] = torch.maximum(M[:, lane], ms)
        P[:, lane] = P[:, lane] + picks
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        o = lanes ^ off
        mn = torch.maximum(M, M[:, o])
        keep = torch.where(M == -math.inf, torch.zeros_like(L), L * torch.exp(M - mn))
        take = torch.where(M[:, o] == -math.inf, torch.zeros_like(L), L[:, o] * torch.exp(M[:, o] - mn))
        A = torch.where((M[:, o] > M) | ((M[:, o] == M) & (A[:, o] < A)), A[:, o], A)
        L, M, P = keep + take, mn, P + P[:, o]
    loss = torch.where(labels >= 0, torch.log(L[:, 0]) + M[:, 0] - P[:, 0], torch.zeros(rows))
    return loss, A[:, 0].to(torch.int32)


# ---------------------------------------------------------------- inputs ---

# Duplicated W rows: a tile boundary, a thread's two rows (r, r + 8), two
# lanes of a warp, two warps, the two warpgroups, one thread in two tiles,
# the ragged tile; the split boundary is added per case.
BASE_PAIRS = ((127, 128), (258, 266), (386, 389), (530, 548), (660, 700), (131, 259), (900, 997))


def _inputs(rows: int, seed: int, split_end: int):
    """f32 feats [B, D], W [V, D], b [V], labels [B], numpy-seeded: W rows
    duplicated in pairs, each row's features pointing at one pair (whose
    logit then leads by far) except every fourth row (random); every
    seventh label −1. Returns them with the pairs."""
    rng = np.random.default_rng(seed)
    pairs = BASE_PAIRS
    if split_end < V and (split_end - 1, split_end) not in pairs:
        pairs += ((split_end - 1, split_end),)
    w = (0.05 * rng.normal(size=(V, D))).astype(np.float32)
    b = (0.1 * rng.normal(size=(V,))).astype(np.float32)
    signs = np.where(rng.random((len(pairs), D)) < 0.5, -1.0, 1.0).astype(np.float32)
    for p, (a, c) in enumerate(pairs):
        w[a] = w[c] = 0.25 * signs[p] * (1 + 0.01 * rng.random(D).astype(np.float32))
        b[c] = b[a]
    feats = np.abs(rng.normal(size=(rows, D))).astype(np.float32)
    for r in range(rows):
        if r % 4 != 3:
            feats[r] *= signs[r % len(pairs)]
    labels = rng.integers(0, V, size=(rows,)).astype(np.int32)
    labels[::7] = -1
    return feats, w, b, labels, pairs


# ----------------------------------------------------------------- tests ---


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 8, 70])
def test_f32_split_head_matches_pallas(rows, num_sms):
    """The six-pair logits in the kernel's order of reduction against the
    JAX Pallas kernel on f32 feats and W: every prediction equal, the tied
    rows on their pair's first column, loss rtol 1e-5."""
    n_split, per_split = f32_geometry(rows, D, V, num_sms)
    feats, w, b, labels, pairs = _inputs(rows, 30 + rows, per_split * TILE)
    ref_loss, ref_pred = jax_head_predict(jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(b),
                                          jnp.asarray(labels), interpret=True)
    logits = split_logits(torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(b))
    for a, c in pairs:
        assert torch.equal(logits[:, a], logits[:, c])  # the ties are exact
    loss, pred = emulate_f32_head(logits, torch.from_numpy(labels), n_split, per_split)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_pred))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    tied = [r for r in range(rows) if r % 4 != 3]
    assert pred.numpy()[tied].tolist() == [pairs[r % len(pairs)][0] for r in tied]
    assert np.all(loss.numpy()[labels < 0] == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_six_pairs_keep_the_f32_product(seed):
    """Against float64 logits the six pairs come within 1e-6 of the largest
    logit; the three-pair control (a0b0, a0b1, a1b0) does not: the pairs of
    order 2^-16 are part of the f32 function."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(np.abs(rng.normal(size=(16, 512))).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.normal(size=(300, 512))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(300,))).astype(np.float32))
    ref = feats.double() @ w.double().t() + b.double()
    six = relative_gap(split_logits(feats, w, b, SIX), ref)
    three = relative_gap(split_logits(feats, w, b, THREE), ref)
    assert six <= SIX_PAIR_GAP < three, (six, three)


def test_split_terms_are_exact():
    """The three bf16 terms of an f32 value add back to it exactly, so the
    six pairs miss only terms of order 2^-24."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4096,)).astype(np.float32))
    t0, t1, t2 = split3(x)
    for t in (t0, t1, t2):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    err = (x.double() - (t0.double() + t1.double() + t2.double())).abs()
    assert bool((err <= 2.0**-24 * x.double().abs()).all())


def test_first_index_ties_in_one_thread_and_across_warps():
    """The kernel's tie rules on hand-made logits: equal values in a
    thread's two rows, in two lanes of a warp, in two warps and in the two
    warpgroups all end at the smallest column."""
    for cols in ((16, 24), (3, 5), (10, 42), (40, 100), (127, 128)):
        logits = torch.zeros(1, 256)
        for c in reversed(cols):
            logits[0, c] = 2.0
        _, pred = emulate_f32_head(logits, torch.tensor([-1]), 1, 2)
        assert pred.tolist() == [min(cols)], cols


@pytest.mark.parametrize("rows", [1, 8, 64, 512])
def test_f32_geometry_fills_the_card(rows):
    """At resnet18's head (D = 512, V = 64 500) on 132 SMs: batch rows a
    CTA 8 at B ≤ 8 and 64 above (two W stages beside 192 KB of feats
    terms), every split holds a tile, V is covered, one wave of at least
    120 CTAs."""
    assert f32_rows(rows, 512) == (8 if rows <= 8 else 64)
    n_split, per_split = f32_geometry(rows, 512, 64500, 132)
    span = per_split * TILE
    assert (n_split - 1) * span < 64500 <= n_split * span
    ctas = -(-rows // f32_rows(rows, 512)) * n_split
    assert 120 <= ctas <= 132, ctas


def test_f32_rows_follow_shared_memory():
    """64 batch rows of feats terms fit up to D = 512; wider heads take 8
    rows a CTA; a head too wide for even 8 rows is refused."""
    assert [f32_rows(512, d) for d in (384, 512, 576, 768)] == [64, 64, 8, 8]
    assert f32_rows(512, 8192) == 0
