"""What the design of the tensor-core heads decides (K4's bf16 route, K7
and the training forward K5, ``csrc/head_predict_tc.cu``), held on the CPU
against the JAX package.

A CUDA kernel cannot run here, so :func:`emulate_tc_head` repeats the
kernels' order of reduction in torch: vocab splits of whole 128-column
tiles (the wrappers' :func:`split_geometry` with the kernels' tile), in
each split every lane of a quad keeping its own online state over its
columns ``n0 + 8j + 2t + e`` tile by tile (the tile's max and its first
column, the running argmax moving only on a strictly larger max, the sum of
``exp2((x − m)·log2 e)``, the label's logit), the quad's four states merged
by a (value, column) shuffle tree in which equal maxima go to the smaller
column, then the splits merged one warp a row, lane s over splits s,
s + 32, ... . It is held against the JAX ``head_predict`` and
``head_predict_int8`` run as Pallas kernels in interpret mode, with exact
ties at tile, split, quad-lane and ragged-tile boundaries. K5 runs the same
fold without the argmax and keeps the merged (m, l) for the backward:
:func:`emulate_tc_ce_forward` is held against the JAX op's forward
(``_fwd_kernel``, interpret mode), its loss and its (m, l) residuals.

Tolerances: predictions exact (the ties are exact in both, and no other
row has a near tie at these seeds); loss rtol 1e-5 with atol 1e-5 (both
sides sum f32 terms, in different orders, and exp2 of a rounded product
stands for exp); K5's m rtol 1e-6 (the max of f32 sums taken in another
order), l rtol 1e-5.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops import quantize as jqz
from mpi_pytorch_tpu.ops.fused_head_ce import _fwd_impl as jax_ce_forward
from mpi_pytorch_tpu.ops.fused_head_ce import head_predict as jax_head_predict
from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh
from mpi_pytorch_tpu_torch.ops import quantize as qz

CSRC = Path(__file__).resolve().parents[1] / "mpi_pytorch_tpu_torch" / "csrc"
LOG2E = np.float32(1.4426950408889634)
D, V = 64, 1000  # 7 whole tiles of 128 and a ragged one of 104
SERVING_BUCKETS = (1, 8, 32, 128, 512)


def _constants(source: str) -> dict[str, int]:
    """The ``constexpr int`` constants of a kernel source, each evaluated
    over the ones declared before it: sums and products of integers and
    earlier constants (the sizes the kernel declares; one that depends on a
    template parameter is left out)."""
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", (CSRC / source).read_text()):
        if re.fullmatch(r"[\w\s()*+-]+", expr) and all(
            n in consts for n in re.findall(r"[A-Za-z_]\w*", expr)
        ):
            consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    return consts


TC = _constants("head_predict_tc.cu")
TC_TILE_VOCAB = TC["kBN"]


def tc_ring_stages(consumers: int, d: int, elem_bytes: int) -> int:
    """W stages the tensor-core kernel's ring holds beside a resident feats
    tile of ``64 × consumers`` rows of D elements (its ``ring_stages``), 0
    when fewer than its least fit."""
    nk = -(-d * elem_bytes // TC["kChunk"])
    left = (TC["kSmemLimit"] - TC["kSmemFixed"] - nk * 64 * consumers * TC["kChunk"]) \
        // TC["kStageBytes"]
    return 0 if left < TC["kMinStages"] else min(left, TC["kMaxStages"])


def tc_tile_rows(rows: int, d: int, elem_bytes: int) -> int:
    """Rows a CTA of the tensor-core heads takes (the kernel's
    ``consumer_groups`` × 64): two consumer warpgroups above B = 64 where
    their feats tile fits, else one; 0 when not even one fits."""
    if rows > 64 and tc_ring_stages(2, d, elem_bytes):
        return 128
    return 64 if tc_ring_stages(1, d, elem_bytes) else 0


def tc_geometry(rows: int, d: int, elem_bytes: int, vocab: int,
                num_sms: int) -> tuple[int, int]:
    return fh.split_geometry(rows, vocab, num_sms, tc_tile_rows(rows, d, elem_bytes),
                             TC_TILE_VOCAB, fh._TC_CTAS_PER_SM)


# ------------------------------------------------------------- emulation ---


def _merge_pair(m, l, arg, om, ol, oa, exp):
    """Two online states merged: the larger max wins, equal maxima go to
    the smaller column; l rescaled to the merged max by ``exp``."""
    mn = torch.maximum(m, om)
    keep = torch.where(m == -math.inf, torch.zeros_like(l), l * exp(m, mn))
    take = torch.where(om == -math.inf, torch.zeros_like(ol), ol * exp(om, mn))
    arg = torch.where((om > m) | ((om == m) & (oa < arg)), oa, arg)
    return mn, keep + take, arg


def _exp2_rel(x, m):
    """exp2(x·log2 e − m·log2 e), −inf → 0, as the partial kernel forms it."""
    mL = torch.where(m == -math.inf, torch.zeros_like(m), m * LOG2E)
    return torch.exp2(x * LOG2E - mL)


def _exp_rel(x, m):
    return torch.exp(x - m)


def _tc_reduce(logits: torch.Tensor, labels: torch.Tensor, n_split: int,
               tiles_per_split: int) -> tuple[torch.Tensor, ...]:
    """The merged (m, l, arg, picked logit) [B] of f32 ``logits`` [B, V]
    reduced in the tensor-core heads' order (module docstring)."""
    rows, vocab = logits.shape
    lab = labels.long()
    t = torch.arange(4)
    j = torch.arange(TC_TILE_VOCAB // 8)
    e = torch.arange(2)
    # Lane t's 32 columns of a tile, ascending: 8j + 2t + e.
    rel = (8 * j[None, :, None] + 2 * t[:, None, None] + e[None, None, :]).reshape(4, -1)
    parts = []
    for s in range(n_split):
        v_begin = s * tiles_per_split * TC_TILE_VOCAB
        v_end = min(vocab, v_begin + tiles_per_split * TC_TILE_VOCAB)
        m = torch.full((rows, 4), -math.inf)
        l = torch.zeros(rows, 4)
        arg = torch.zeros(rows, 4, dtype=torch.long)
        pick = torch.zeros(rows, 4)
        for n0 in range(v_begin, v_end, TC_TILE_VOCAB):
            cols = n0 + rel  # [4, 32]
            x = logits[:, cols.clamp(max=vocab - 1)]  # [B, 4, 32]
            x = torch.where(cols[None] >= v_end, torch.full_like(x, -math.inf), x)
            mx, at = x.max(dim=-1)  # the first column attaining the max
            ax = torch.gather(cols.expand(rows, 4, -1), 2, at[..., None])[..., 0]
            arg = torch.where(mx > m, ax, arg)  # strict: an earlier tile keeps a tie
            mn = torch.maximum(m, mx)
            l = l * _exp2_rel(m, mn) + _exp2_rel(x, mn[..., None]).sum(-1)
            m = mn
            hit = cols[None] == lab[:, None, None]
            pick = pick + torch.where(hit, x, torch.zeros_like(x)).sum(-1)
        # The quad's shuffle tree: lanes xor 1, then xor 2.
        for off in (1, 2):
            o = t ^ off
            m, l, arg = _merge_pair(m, l, arg, m[:, o], l[:, o], arg[:, o], _exp2_rel)
            pick = pick + pick[:, o]
        parts.append((m[:, 0], l[:, 0], arg[:, 0], pick[:, 0]))
    # The merge: lane s over splits s, s + 32, ...; then xor 16, 8, 4, 2, 1.
    M = torch.full((rows, 32), -math.inf)
    L = torch.zeros(rows, 32)
    A = torch.full((rows, 32), 2**31 - 1, dtype=torch.long)
    P = torch.zeros(rows, 32)
    for s, (ms, ls, args, picks) in enumerate(parts):
        lane = s % 32
        up = ms > M[:, lane]
        L[:, lane] = torch.where(up, L[:, lane] * _exp_rel(M[:, lane], ms) + ls,
                                 L[:, lane] + ls * _exp_rel(ms, M[:, lane]))
        A[:, lane] = torch.where(up, args, A[:, lane])
        M[:, lane] = torch.maximum(M[:, lane], ms)
        P[:, lane] = P[:, lane] + picks
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        o = lanes ^ off
        P = P + P[:, o]
        M, L, A = _merge_pair(M, L, A, M[:, o], L[:, o], A[:, o], _exp_rel)
    return M[:, 0], L[:, 0], A[:, 0], P[:, 0]


def _ce_loss(m, l, pick, labels):
    return torch.where(labels >= 0, torch.log(l) + m - pick, torch.zeros_like(m))


def emulate_tc_head(logits: torch.Tensor, labels: torch.Tensor, n_split: int,
                    tiles_per_split: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, pred) of f32 ``logits`` [B, V] reduced in the tensor-core
    heads' order (module docstring)."""
    m, l, arg, pick = _tc_reduce(logits, labels, n_split, tiles_per_split)
    return _ce_loss(m, l, pick, labels), arg.to(torch.int32)


def emulate_tc_ce_forward(logits: torch.Tensor, labels: torch.Tensor, n_split: int,
                          tiles_per_split: int) -> tuple[torch.Tensor, ...]:
    """K5's (loss, m, l): the same fold and merge with no argmax kept — the
    kernel's fold takes the max alone, which leaves m, l and the picked
    logit as they are."""
    m, l, _, pick = _tc_reduce(logits, labels, n_split, tiles_per_split)
    return _ce_loss(m, l, pick, labels), m, l


# ---------------------------------------------------------------- inputs ---

# Duplicated W rows: a tile boundary, the split boundary (added per case
# where it is another), two lanes of a quad, two columns of one lane, one
# lane in two tiles, two splits, the ragged tile.
BASE_PAIRS = ((127, 128), (260, 262), (400, 408), (130, 258), (100, 700), (900, 997))


def _inputs(rows: int, seed: int, split_end: int):
    """feats [B, D], W [V, D], b [V] and labels [B] in f32, numpy-seeded:
    W rows duplicated in pairs, each row's features pointing at one pair
    (whose logit then leads by far) except every fourth row (random); every
    seventh label −1. Returns them with the pairs."""
    rng = np.random.default_rng(seed)
    pairs = BASE_PAIRS
    if split_end < V and (split_end - 1, split_end) not in pairs:
        pairs += ((split_end - 1, split_end),)
    w = (0.05 * rng.normal(size=(V, D))).astype(np.float32)
    b = (0.1 * rng.normal(size=(V,))).astype(np.float32)
    signs = np.where(rng.random((len(pairs), D)) < 0.5, -1.0, 1.0).astype(np.float32)
    for p, (a, c) in enumerate(pairs):
        w[a] = w[c] = 0.25 * signs[p]
        b[c] = b[a]
    feats = np.abs(rng.normal(size=(rows, D))).astype(np.float32)
    for r in range(rows):
        if r % 4 != 3:
            feats[r] *= signs[r % len(pairs)]
    labels = rng.integers(0, V, size=(rows,)).astype(np.int32)
    labels[::7] = -1
    return feats, w, b, labels, pairs


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ----------------------------------------------------------------- tests ---


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 8, 70])
def test_bf16_fold_order_matches_pallas(rows, num_sms):
    """(a) K4 bf16's order of reduction against the JAX Pallas kernel."""
    n_split, per_split = tc_geometry(rows, D, 2, V, num_sms)
    feats, w, b, labels, pairs = _inputs(rows, 10 + rows, per_split * TC_TILE_VOCAB)
    fb, wb = _bf16(feats), _bf16(w)
    ref_loss, ref_pred = jax_head_predict(
        jnp.asarray(fb).astype(jnp.bfloat16), jnp.asarray(wb.T), jnp.asarray(b),
        jnp.asarray(labels), interpret=True,
    )
    # bf16 × bf16 products are exact in f64; the sum rounds once to f32.
    logits = (torch.from_numpy(fb).double() @ torch.from_numpy(wb).double().t()).float()
    logits = logits + torch.from_numpy(b)
    loss, pred = emulate_tc_head(logits, torch.from_numpy(labels), n_split, per_split)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_pred))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    tied = [r for r in range(rows) if r % 4 != 3]
    want = [pairs[r % len(pairs)][0] for r in tied]
    assert pred.numpy()[tied].tolist() == want  # the first column of every pair
    assert np.all(loss.numpy()[labels < 0] == 0)


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 8, 70])
def test_int8_fold_order_matches_pallas(rows, num_sms):
    """(a) K7's order of reduction against the JAX Pallas kernel: the
    logits are the same bits, so the predictions agree on every row."""
    n_split, per_split = tc_geometry(rows, D, 1, V, num_sms)
    feats, w, b, labels, pairs = _inputs(rows, 20 + rows, per_split * TC_TILE_VOCAB)
    w_q, w_scale = jqz.quantize_per_channel(jnp.asarray(w.T))
    act = float(np.abs(feats).max()) / 127.0
    ref_loss, ref_pred = jqz.head_predict_int8(
        jnp.asarray(feats), w_q, jnp.asarray(b), jnp.asarray(labels), w_scale, act,
        interpret=True,
    )
    wq = torch.from_numpy(np.asarray(w_q).T.copy())
    scale_v = qz.combined_scale(torch.from_numpy(np.array(w_scale)), act)
    logits = qz.int8_logits(torch.from_numpy(feats), wq, torch.from_numpy(b), scale_v, act)
    loss, pred = emulate_tc_head(logits, torch.from_numpy(labels), n_split, per_split)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_pred))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    tied = [r for r in range(rows) if r % 4 != 3]
    assert pred.numpy()[tied].tolist() == [pairs[r % len(pairs)][0] for r in tied]


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 8, 70, 128])
def test_ce_forward_fold_matches_pallas(rows, num_sms):
    """(a) K5: the bf16 fold over ``tc_geometry``'s splits, no argmax,
    against the JAX op's Pallas forward (``_fwd_kernel``): the loss and the
    rows' (m, l) that the backward recomputes its softmax from."""
    n_split, per_split = tc_geometry(rows, D, 2, V, num_sms)
    feats, w, b, labels, _ = _inputs(rows, 30 + rows, per_split * TC_TILE_VOCAB)
    fb, wb = _bf16(feats), _bf16(w)
    ref_loss, ref_m, ref_l, *_ = jax_ce_forward(
        jnp.asarray(fb).astype(jnp.bfloat16), jnp.asarray(w.T), jnp.asarray(b),
        jnp.asarray(labels), True,
    )
    logits = (torch.from_numpy(fb).double() @ torch.from_numpy(wb).double().t()).float()
    logits = logits + torch.from_numpy(b)
    loss, m, l = emulate_tc_ce_forward(logits, torch.from_numpy(labels), n_split, per_split)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m)[:, 0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(l.numpy(), np.asarray(ref_l)[:, 0], rtol=1e-5, atol=0)
    assert np.all(loss.numpy()[labels < 0] == 0)


def test_quad_tie_goes_to_the_smaller_column():
    """The quad's merge compares (value, column): equal maxima in four
    lanes end at the smallest column whichever lane holds it."""
    logits = torch.zeros(1, 128)
    for c in (6, 3, 9, 5):  # lanes 3, 1, 0, 2 (column 8j + 2t + e)
        logits[0, c] = 2.0
    _, pred = emulate_tc_head(logits, torch.tensor([-1]), 1, 1)
    assert pred.tolist() == [3]


# The heads' widths on the serving path: resnet18 (bf16 and int8), vit_s16
# and vit_b16 (bf16).
HEAD_WIDTHS = ((512, 2), (512, 1), (384, 2), (768, 2))


@pytest.mark.parametrize("d,elem_bytes", HEAD_WIDTHS)
@pytest.mark.parametrize("rows", SERVING_BUCKETS)
def test_tc_split_geometry_fills_the_card(rows, d, elem_bytes):
    """(b) The tensor-core heads' splits at V = 64 500 on 132 SMs: every
    split holds a tile, V is covered, and the grid is one wave of at least
    120 CTAs (one an SM)."""
    n_split, per_split = tc_geometry(rows, d, elem_bytes, 64500, 132)
    span = per_split * TC_TILE_VOCAB
    assert (n_split - 1) * span < 64500 <= n_split * span
    ctas = -(-rows // tc_tile_rows(rows, d, elem_bytes)) * n_split
    assert 120 <= ctas <= 132, ctas


def test_tc_tile_rows_follow_shared_memory():
    """The row tile the kernel's shared memory allows: two consumer
    warpgroups above B = 64 up to D = 512 (bf16) and beyond for int8, one
    at vit_b16's D = 768 in bf16 (two feats tiles leave too few W stages),
    none when one feats tile does not fit."""
    assert [tc_tile_rows(r, 512, 2) for r in (1, 64, 65, 512)] == [64, 64, 128, 128]
    assert tc_tile_rows(512, 768, 2) == 64 and tc_tile_rows(512, 768, 1) == 128
    assert tc_tile_rows(1, 4096, 2) == 0
    assert TC["kMinStages"] <= tc_ring_stages(1, 768, 2) <= TC["kMaxStages"]


def test_ce_forward_split_geometry():
    """(b) K5's geometry is K4 bf16's (``tc_geometry`` with 2-byte feats):
    at resnet18's D = 512 and V = 64 500 on 132 SMs, one wave of one CTA an
    SM, whose consumer warpgroups take 64 rows each."""
    got = {rows: tc_geometry(rows, 512, 2, 64500, 132) for rows in (1, 8, 128, 512)}
    assert got == {1: (126, 4), 8: (126, 4), 128: (126, 4), 512: (32, 16)}
    assert [tc_tile_rows(r, 512, 2) for r in (8, 128, 512)] == [64, 128, 128]


def test_int8_epilogue_rounds_twice():
    """(c) ``float(acc)·scale_v + b`` as two f32 roundings is
    ``int8_logits``' bits; rounding once (the product and sum in f64, as
    an FMA would keep them) gives other bits on some elements."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(16, 256)).astype(np.float32)
    w = (0.05 * rng.normal(size=(2000, 256))).astype(np.float32)
    b = (0.1 * rng.normal(size=(2000,))).astype(np.float32)
    w_q, w_scale = qz.quantize_per_channel(torch.from_numpy(w))
    act = float(np.abs(feats).max()) / 127.0
    scale_v = qz.combined_scale(w_scale, act)
    f = torch.from_numpy(feats)
    acc = qz.quantize_activations(f, act).double() @ w_q.double().t()
    twice = (acc.float() * scale_v) + torch.from_numpy(b)
    once = (acc.float().double() * scale_v.double() + torch.from_numpy(b).double()).float()
    want = qz.int8_logits(f, w_q, torch.from_numpy(b), scale_v, act)
    assert torch.equal(twice, want)
    assert int((once != want).sum()) > 0


def test_cpu_tensors_move_no_head_counter():
    """(d) On CPU tensors the wrappers run their plain versions and count
    no launch of any head kernel."""
    f, w = torch.rand(4, 32), torch.rand(10, 32)
    b, lab = torch.zeros(10), torch.tensor([1, -1, 3, 9], dtype=torch.int32)
    counters = (fh.counter, fh.counter_f32, qz.counter)
    before = [c.count for c in counters]
    fh.head_predict(f, w, b, lab)
    fh.head_predict(f.to(torch.bfloat16), w.to(torch.bfloat16), b, lab)
    w_q, w_scale = qz.quantize_per_channel(w)
    qz.head_predict_int8(f, w_q, b, lab, w_scale, 0.01)
    assert [c.count for c in counters] == before
