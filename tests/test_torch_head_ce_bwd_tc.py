"""What the design of the training head's backward on the tensor cores
decides (K6, ``csrc/fused_head_ce_bwd.cu``), held on the CPU against the
JAX op's Pallas backward (``_bwd_kernel``, interpret mode).

A CUDA kernel cannot run here, so :func:`emulate_ce_backward` repeats the
kernels' arithmetic and order in torch:

- pass 1 walks the vocab in tiles of the kernel's width and the batch in
  chunks of the rows its shared memory holds (``chunk_rows``, the kernel's
  rule); a tile's logits are bf16 products summed in f32 plus the f32
  bias; dlog = (p − onehot)·g in f32, p = exp(x − m)·(1/l) with 1/l
  rounded once a row, 0 on padding rows, rows past B and vocab rows past
  V; db is each thread's f32 sum over its columns 8j + 2t + e of the chunk
  (j, then e, ascending), then the quad's (t ⊕ 1, then t ⊕ 2), added to
  the earlier chunks' in chunk order; dW is bf16(dlog)ᵀ·feats a chunk,
  added to the earlier chunks' in chunk order; bf16(dlog) lands in the
  dlogᵀ scratch;
- pass 2 sums bf16(dlog)·W over vocab splits of ``tiles_per_split`` tiles
  (the wrapper's ``backward_plan``), each an f32 partial, and the reduce
  adds the partials in split order and rounds to bf16.

Tolerances: the emulation takes the JAX forward's own (m, l). dW and db
rtol 1e-3 (the f32 sums run in other orders: a wgmma's f32 sum is not
rounded to nearest, so the products are emulated exactly and rounded
once), atol 5e-5: dlog is rounded to bf16 on both sides from exponentials
that may differ in their last bits, and a dlog at a rounding boundary
rounds either way (db sums the unrounded dlog). One such flip moves a dW
element by a bf16 ulp of that dlog times a feature: at V = 1 000 a dlog
off its label is below 1.2e-2 (ulp 6.1e-5) and a feature below 4.2; the
flips at these seeds moved a dW element by at most 1.8e-5. dfeats is
rounded to bf16 at the end on both sides, from f32 sums in other orders:
within one bf16 ulp (rtol 2⁻⁸), atol 5e-5.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_head_ce import _fwd_impl as jax_ce_forward
from mpi_pytorch_tpu.ops.fused_head_ce import fused_head_ce as jax_fused_head_ce
from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

CSRC = Path(__file__).resolve().parents[1] / "mpi_pytorch_tpu_torch" / "csrc"
D, V = 64, 1000  # 7 whole vocab tiles of 128 and a ragged one of 104


def _constants() -> dict[str, int]:
    """The backward source's ``constexpr int`` sizes, each evaluated over
    the ones declared before it."""
    consts: dict[str, int] = {}
    text = (CSRC / "fused_head_ce_bwd.cu").read_text()
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        if re.fullmatch(r"[\w\s()*+-]+", expr) and all(
            n in consts for n in re.findall(r"[A-Za-z_]\w*", expr)
        ):
            consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    return consts


K = _constants()


def chunk_rows(rows: int, d: int) -> int:
    """Pass 1's batch rows a chunk (the kernel's ``chunk_rows``): 128 above
    64 rows where the feats chunk leaves room for the W rings, else 64; 0
    when not even 64 rows fit."""
    nk = -(-d // 64)

    def stages(nb: int) -> int:  # of each consumer warpgroup's W ring
        rings = K["kConsumers"]
        fixed = 1024 + ((nk + 1) & ~1) * nb * K["kAtom"] + 8 * (2 * rings * K["kMaxStages"] + 2) \
            + 16 * nb
        left = (K["kSmemLimit"] - fixed) // (rings * K["kStageBytes"])
        return 0 if left < K["kMinStages"] else min(left, K["kMaxStages"])

    if rows > 64 and stages(128):
        return 128
    return 64 if stages(64) else 0


def plan(rows: int, d: int, vocab: int, num_sms: int) -> dict[str, int]:
    return fh.backward_plan(rows, d, vocab, num_sms, K["kTileV"], K["kTileB"], K["kTileD"])


# ------------------------------------------------------------- emulation ---


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _db_chunk(d: torch.Tensor, nb: int) -> torch.Tensor:
    """A chunk's db [V] from its f32 dlog [rows, V] (rows ≤ nb, the rest
    zero): thread t sums its columns 8j + 2t + e in order, then the quad
    adds t ⊕ 1, then t ⊕ 2."""
    padded = torch.zeros(nb, d.shape[1])
    padded[: d.shape[0]] = d
    part = torch.zeros(4, d.shape[1])
    for j in range(nb // 8):
        for t in range(4):
            for e in range(2):
                part[t] = part[t] + padded[8 * j + 2 * t + e]
    part = part + part[[1, 0, 3, 2]]
    part = part + part[[2, 3, 0, 1]]
    return part[0]


def emulate_ce_backward(feats, w, b, labels, m, l, g, num_sms: int, nb: int | None = None):
    """(dfeats [B, D] bf16 values in f32, dW [V, D], db [V]) of bf16-valued
    f32 ``feats`` and ``w`` [V, D] in the kernels' order (module
    docstring); ``nb`` overrides the batch chunk."""
    rows, d = feats.shape
    vocab = w.shape[0]
    nb = nb or chunk_rows(rows, d)
    geo = plan(rows, d, vocab, num_sms)
    tile = K["kTileV"]
    logits = (feats.double() @ w.double().t()).float() + b
    gv = torch.where(labels >= 0, g, torch.zeros_like(g))
    dw = torch.zeros(vocab, d)
    db = torch.zeros(vocab)
    dlog_t = torch.zeros(geo["vp"], geo["bs"])
    for c0 in range(0, rows, nb):
        r = slice(c0, min(rows, c0 + nb))
        p = torch.exp(logits[r] - m[r, None]) * (1 / l[r, None])
        onehot = (torch.arange(vocab)[None] == labels[r].long()[:, None]).float()
        dl = (p - onehot) * gv[r, None]
        db = (db if c0 else torch.zeros(vocab)) + _db_chunk(dl, nb)
        d16 = _bf16(dl)
        part = (d16.double().t() @ feats[r].double()).float()
        dw = part if c0 == 0 else dw + part
        dlog_t[:vocab, r] = d16.t()
    w_pad = torch.zeros(geo["vp"], d)
    w_pad[:vocab] = w
    total = torch.zeros(rows, d)
    span = geo["tiles_per_split"] * tile
    for s in range(geo["n_split"]):
        v = slice(s * span, min(geo["vp"], (s + 1) * span))
        total = total + (dlog_t[v, :rows].t().double() @ w_pad[v].double()).float()
    return _bf16(total), dw, db


# ---------------------------------------------------------------- inputs ---


def _inputs(rows: int, seed: int):
    """bf16-valued feats [B, D] and W [V, D], f32 b, labels (every 7th −1,
    one in the ragged last vocab tile), g, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    feats = _bf16(torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32)))
    w = _bf16(torch.from_numpy((0.05 * rng.normal(size=(V, D))).astype(np.float32)))
    b = torch.from_numpy((0.1 * rng.normal(size=(V,))).astype(np.float32))
    labels = rng.integers(0, V, size=(rows,)).astype(np.int32)
    labels[::7] = -1
    labels[1 % rows] = V - 3
    g = torch.from_numpy(rng.uniform(0.1, 2.0, size=(rows,)).astype(np.float32))
    return feats, w, b, torch.from_numpy(labels), g


def _jax_backward(feats, w, b, labels, g):
    """The JAX op's (m, l) and gradients (dfeats, dW [V, D], db), its
    Pallas kernels in interpret mode."""
    lab = jnp.asarray(labels.numpy())
    args = (jnp.asarray(feats.numpy()), jnp.asarray(w.numpy().T), jnp.asarray(b.numpy()))

    def total(f, w_t, bias):
        return jnp.sum(jax_fused_head_ce(f, w_t, bias, lab, interpret=True) * jnp.asarray(g.numpy()))

    _, m, l, *_ = jax_ce_forward(args[0].astype(jnp.bfloat16), *args[1:], lab, True)
    gf, gw, gb = jax.grad(total, argnums=(0, 1, 2))(*args)
    to = lambda x: torch.from_numpy(np.asarray(x).copy())  # noqa: E731
    return to(m)[:, 0], to(l)[:, 0], (to(gf), to(gw).t(), to(gb))


# ----------------------------------------------------------------- tests ---


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("rows", [1, 8, 70, 200])
def test_backward_emulation_matches_pallas(rows, num_sms):
    """K6's arithmetic and order against the JAX Pallas backward: B = 1, 8
    and 70 in one batch chunk (64 or 128 rows), B = 200 in two chunks of
    128; V's ragged last tile; pass 2 over 132 SMs' splits and 3 SMs'."""
    feats, w, b, labels, g = _inputs(rows, 40 + rows)
    m, l, want = _jax_backward(feats, w, b, labels, g)
    got = emulate_ce_backward(feats, w, b, labels, m, l, g, num_sms)
    for name, x, y, rtol in zip(("dfeats", "dW", "db"), got, want, (2**-8, 1e-3, 1e-3)):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol, atol=5e-5, err_msg=name)
    assert bool((got[0][labels < 0] == 0).all())  # padding rows: dfeats 0


def test_batch_chunks_add_in_order():
    """Batches past one chunk: the chunked dW and db (64-row chunks, the
    later added to the earlier) against one chunk of all rows, within f32
    rounding; dfeats does not depend on the chunking."""
    feats, w, b, labels, g = _inputs(150, 7)
    m, l, _ = _jax_backward(feats, w, b, labels, g)
    one = emulate_ce_backward(feats, w, b, labels, m, l, g, 132, nb=256)
    chunked = emulate_ce_backward(feats, w, b, labels, m, l, g, 132, nb=64)
    torch.testing.assert_close(chunked[0], one[0], rtol=0, atol=0)
    for x, y in zip(chunked[1:], one[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


def test_chunk_rows_follow_shared_memory():
    """Pass 1's batch chunk: 64 rows up to B = 64, 128 above at resnet18's
    D = 512; 64 at vit_b16's D = 768 (128 rows leave too few W stages);
    none when not even 64 rows fit."""
    assert [chunk_rows(r, 512) for r in (1, 8, 64, 65, 128, 512)] == [64, 64, 64, 128, 128, 128]
    assert chunk_rows(128, 768) == 64 and chunk_rows(1, 4096) == 0


@pytest.mark.parametrize("rows", [8, 128, 512])
def test_backward_plan_fills_the_card(rows):
    """At D = 512, V = 64 500 on 132 SMs: pass 1 runs one wave of CTAs
    with an even share of the 504 vocab tiles each (126 CTAs × 4); pass 2's
    splits cover the vocab, none empty, in one wave of at least 120 CTAs;
    the scratch is padded to the tiles."""
    geo = plan(rows, 512, 64500, 132)
    tiles = -(-64500 // K["kTileV"])
    assert geo["n_ctas"] == 126 and tiles % geo["n_ctas"] == 0
    per = geo["tiles_per_split"]
    assert (geo["n_split"] - 1) * per < tiles <= geo["n_split"] * per
    ctas = geo["bp"] // K["kTileB"] * (geo["dp"] // K["kTileD"]) * geo["n_split"]
    assert 120 <= ctas <= 132, ctas
    assert geo["vp"] == tiles * K["kTileV"] and geo["bs"] % 8 == 0 and geo["bs"] >= rows
