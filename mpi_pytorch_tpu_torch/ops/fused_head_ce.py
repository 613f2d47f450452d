"""The classifier head fused into softmax cross-entropy, without storing
the [B, V] logits: the streaming predict head and the training op.

Counterpart of ``mpi_pytorch_tpu/ops/fused_head_ce.py``:

- :func:`head_predict` (``_predict_kernel`` + ``online_predict_update``):
  per-row cross-entropy and argmax of ``feats @ Wᵀ + b``. Semantics carried
  over exactly: argmax takes the first index attaining the max, loss is
  ``logsumexp(logits) − logits[label]``, and rows with ``label < 0`` (batch
  padding) get loss 0. Forward only.
- :func:`fused_head_ce` (the custom-VJP op over ``_fwd_kernel`` and
  ``_bwd_kernel``): the per-row loss, differentiable in feats, W and b. It
  rounds where the JAX op rounds: feats and W to bf16, logits summed in
  f32 plus the f32 bias; the backward forms ``dlog = (softmax − onehot)·g``
  in f32, rounds it to bf16 for both gradient products (f32 sums), keeps
  ``db`` in f32 and returns ``dfeats`` rounded to bf16, then cast to the
  caller's dtypes.

Layout differs from the JAX functions on purpose: W is ``[V, D]``
(K-major — a ``torch.nn.Linear`` weight as it stands), so the kernels
stream contiguous rows of it and the serving path keeps one bf16 copy
built once instead of re-casting per call; ``fused_head_ce``'s dW comes
back ``[V, D]`` too.

On a CUDA tensor :func:`head_predict` launches a kernel or raises: bf16
feats and W through the wgmma kernel of ``csrc/head_predict_tc.cu``
(TMA-fed, the softmax and argmax folded in registers), or f32 feats and W
through that file's f32 wgmma kernel (an f32 model keeps an f32 head, as
the JAX function's f32 kernel does: each f32 product is six exact bf16
products of three-term splits of feats and W, summed smallest first, the
arithmetic ``ops/attention_split_numerics.split_product`` writes down;
no TF32), with f32 bias and int32 labels. On a CPU tensor it runs
:func:`head_predict_reference`, the plain PyTorch version.
:func:`fused_head_ce` on a CUDA tensor runs its forward kernel (the bf16
wgmma kernel of ``csrc/head_predict_tc.cu`` without its argmax, with a
merge that keeps the rows' max and sum for the backward) and its backward
kernels (``csrc/fused_head_ce_bwd.cu``: the logits recomputed on wgmma
vocab × batch, dlog in registers as the A operand of dW, then dfeats as a
split-K wgmma product); on a CPU tensor the plain forward and backward of
:func:`fused_head_ce_reference`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.ops import _build

# Launches of head_predict's kernels (one per call on the card): the bf16
# tensor-core kernel, and the f32 one.
counter = _build.LaunchCounter()
counter_f32 = _build.LaunchCounter()
# Launches of the training op's forward and backward kernels (one per call
# of each on the card).
ce_forward_counter = _build.LaunchCounter()
ce_backward_counter = _build.LaunchCounter()

# CTAs to aim for on each SM of an H100 (132 SMs) when choosing the number
# of vocab splits, so that even batch 1 fills the card: one, for every
# head kernel (K4 bf16 and f32, K5, K6, K7) holds most of an SM's shared
# memory.
_TC_CTAS_PER_SM = 1


def _logits(feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return feats.float() @ w.float().t() + b.float()


def head_ce_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Plain per-row CE from explicit f32 logits; 0 where ``label < 0``."""
    logits = _logits(feats, w, b)
    valid = labels >= 0
    per = F.cross_entropy(logits, labels.clamp(min=0).long(), reduction="none")
    return torch.where(valid, per, torch.zeros_like(per))


def head_predict_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: explicit f32 logits, CE + first-index
    argmax. Returns (loss f32 [B], pred int32 [B])."""
    logits = _logits(feats, w, b)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    return head_ce_reference(feats, w, b, labels), preds


@functools.lru_cache(maxsize=None)
def _num_sms(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_geometry(
    rows: int, vocab: int, num_sms: int, block_rows: int, block_v: int, ctas_per_sm: int
) -> tuple[int, int]:
    """(n_split, tiles_per_split) for a head kernel whose CTAs take
    ``block_rows`` rows and tiles of ``block_v`` vocab rows: enough vocab
    splits that the grid holds about, and at most, ``ctas_per_sm × num_sms``
    CTAs (one wave), with no empty split."""
    row_tiles = -(-rows // block_rows)
    v_tiles = -(-vocab // block_v)
    want = max(1, ctas_per_sm * num_sms // row_tiles)
    tiles_per_split = -(-v_tiles // min(want, v_tiles))
    return -(-v_tiles // tiles_per_split), tiles_per_split


def tc_geometry(rows: int, d: int, vocab: int, elem_bytes: int, num_sms: int,
                what: str) -> tuple[int, int]:
    """The split geometry of the tensor-core heads (K4 bf16 and f32, K5,
    K7) for feats of ``elem_bytes``-byte elements; raises when D is too
    wide for their resident feats tile."""
    lib = _build.load_library()
    block_rows = lib.mpt_head_tc_tile_rows(rows, d, elem_bytes)
    if block_rows == 0:
        raise ValueError(
            f"{what} kernel keeps a feats tile in shared memory: D={d} is too wide"
        )
    return split_geometry(rows, vocab, num_sms, block_rows, lib.mpt_head_tc_tile_vocab(),
                          _TC_CTAS_PER_SM)


def check_shapes(feats, w, b, labels, what: str = "head_predict") -> None:
    """Raise unless feats [B, D], w [V, D], b [V] and labels [B] fit."""
    if feats.dim() != 2 or w.dim() != 2 or w.shape[1] != feats.shape[1]:
        raise ValueError(
            f"{what} takes feats [B, D] and w [V, D], got "
            f"{tuple(feats.shape)} and {tuple(w.shape)}"
        )
    if tuple(b.shape) != (w.shape[0],) or tuple(labels.shape) != (feats.shape[0],):
        raise ValueError(
            f"{what} takes b [V] and labels [B], got {tuple(b.shape)} "
            f"and {tuple(labels.shape)}"
        )


def check_kernel_operands(what: str, dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies contiguous and 16-byte aligned on
    ``dev``, as the kernels read them."""
    for name, t in tensors.items():
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what} kernel needs {name} contiguous on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs {name} 16-byte aligned")


def head_predict(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-row CE f32 [B], argmax int32 [B]) of ``softmax(feats @ wᵀ + b)``.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Forward only: the predictions path never backpropagates."""
    check_shapes(feats, w, b, labels)
    if _build.on_cpu(feats, "head_predict"):
        return head_predict_reference(feats, w, b, labels)
    if torch.is_grad_enabled() and (feats.requires_grad or w.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "head_predict is forward-only (the predictions path never "
            "backpropagates); train through fused_head_ce, whose forward "
            "and backward are kernels"
        )
    if feats.dtype not in _build.DTYPE_CODE or w.dtype != feats.dtype:
        raise TypeError(
            f"head_predict's CUDA kernel takes bf16 or f32 feats and W of the "
            f"same dtype, got {feats.dtype} and {w.dtype}"
        )
    if b.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"head_predict needs f32 b and int32 labels, got {b.dtype}, {labels.dtype}")
    bsz, d = feats.shape
    vocab = w.shape[0]
    if d % 16:
        raise ValueError(f"head_predict kernel needs D % 16 == 0, got D={d}")
    dev = feats.device
    check_kernel_operands("head_predict", dev, feats=feats, w=w, b=b, labels=labels)
    lib = _build.load_library()
    n_split, tiles_per_split = tc_geometry(bsz, d, vocab, feats.element_size(),
                                           _num_sms(dev.index), "head_predict")
    if feats.dtype == torch.bfloat16:
        entry, launches = lib.mpt_head_predict_bf16, counter
    else:
        entry, launches = lib.mpt_head_predict_f32, counter_f32
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    pred = torch.empty((bsz,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = entry(
            feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            loss.data_ptr(), pred.data_ptr(), part_mlp.data_ptr(), part_arg.data_ptr(),
            bsz, d, vocab, n_split, tiles_per_split, _build.stream(dev),
        )
    _build.check(code, "head_predict")
    launches.add()
    return loss, pred


# --------------------------------------------------------------------------
# the training op: fused_head_ce (forward and backward kernels)
# --------------------------------------------------------------------------


def fused_head_ce_forward_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain forward over the op's operands (bf16 feats and W, f32 b,
    int32 labels): (loss, m, l) f32 [B] with explicit f32 logits, m the
    row max, l = Σ exp(logit − m) and loss = log l + m − logit[label], 0
    where label < 0."""
    logits = _logits(feats, w, b)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[:, None]).sum(dim=-1)
    valid = labels >= 0
    picked = logits.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    loss = torch.where(valid, torch.log(l) + m - picked, torch.zeros_like(m))
    return loss, m, l


def fused_head_ce_backward_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, rounding where the JAX ``_bwd_kernel`` rounds:
    ``dlog = (exp(logit − m) / l − onehot)·g`` in f32 (g = 0 where label <
    0), rounded to bf16 for ``dW = dlogᵀ·feats`` [V, D] and ``dfeats =
    dlog·W`` (f32 sums, dfeats then rounded to bf16); ``db = Σ dlog`` in
    f32."""
    logits = _logits(feats, w, b)
    valid = labels >= 0
    p = torch.exp(logits - m[:, None]) / l[:, None]
    onehot = F.one_hot(labels.clamp(min=0).long(), w.shape[0]).to(p.dtype) * valid[:, None]
    dlog = (p - onehot) * torch.where(valid, g.float(), torch.zeros_like(m))[:, None]
    d16 = dlog.to(torch.bfloat16).float()
    dw = d16.t() @ feats.float()
    dfeats = (d16 @ w.float()).to(torch.bfloat16)
    return dfeats, dw, dlog.sum(dim=0)


def _ce_kernel_checks(feats, w, b, labels, what: str) -> None:
    if feats.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 feats and W, got {feats.dtype}, {w.dtype}")
    if b.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"{what} kernel needs f32 b and int32 labels, got {b.dtype}, {labels.dtype}")
    if feats.shape[1] % 16:
        raise ValueError(f"{what} kernel needs D % 16 == 0, got D={feats.shape[1]}")


def _ce_forward(feats, w, b, labels):
    """K5: (loss, m, l) f32 [B] from the forward kernel."""
    _ce_kernel_checks(feats, w, b, labels, "fused_head_ce forward")
    dev = feats.device
    check_kernel_operands("fused_head_ce forward", dev, feats=feats, w=w, b=b, labels=labels)
    bsz, d = feats.shape
    vocab = w.shape[0]
    n_split, tiles_per_split = tc_geometry(bsz, d, vocab, 2, _num_sms(dev.index),
                                           "fused_head_ce forward")
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    loss, m, l = (torch.empty((bsz,), dtype=torch.float32, device=dev) for _ in range(3))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mpt_head_ce_fwd(
            feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            loss.data_ptr(), m.data_ptr(), l.data_ptr(), part_mlp.data_ptr(),
            bsz, d, vocab, n_split, tiles_per_split, _build.stream(dev),
        )
    _build.check(code, "fused_head_ce forward")
    ce_forward_counter.add()
    return loss, m, l


def backward_plan(rows: int, d: int, vocab: int, num_sms: int, tile_vocab: int,
                  tile_rows: int, tile_cols: int) -> dict[str, int]:
    """The backward kernels' geometry for a batch of ``rows`` and D = ``d``:
    the padded sizes of their scratch — dlogᵀ [vp, bs] (bs: 16-byte rows),
    the dfeats partials [n_split, bp, dp] — the CTAs of pass 1 (an even
    share of the vocab tiles each, at most one an SM), and pass 2's vocab
    splits of ``tiles_per_split`` tiles: as many as keep its grid within
    one CTA an SM, none empty."""
    tiles = -(-vocab // tile_vocab)
    bp, dp = -(-rows // tile_rows) * tile_rows, -(-d // tile_cols) * tile_cols
    n_ctas = -(-tiles // -(-tiles // min(tiles, num_sms)))
    want = max(1, _TC_CTAS_PER_SM * num_sms // ((bp // tile_rows) * (dp // tile_cols)))
    per_split = -(-tiles // min(want, tiles))
    return {"vp": tiles * tile_vocab, "bs": -(-rows // 8) * 8, "bp": bp, "dp": dp,
            "n_ctas": n_ctas, "n_split": -(-tiles // per_split), "tiles_per_split": per_split}


def backward_geometry(rows: int, d: int, vocab: int, num_sms: int) -> dict[str, int]:
    """:func:`backward_plan` with the kernels' own tiles; raises when D is
    too wide for pass 1's resident feats chunk."""
    lib = _build.load_library()
    if lib.mpt_head_ce_bwd_rows(rows, d) == 0:
        raise ValueError(
            f"fused_head_ce backward kernel keeps a feats chunk in shared memory: D={d} is too wide"
        )
    return backward_plan(rows, d, vocab, num_sms, lib.mpt_head_ce_bwd_tile_vocab(),
                         lib.mpt_head_ce_bwd_tile_rows(), lib.mpt_head_ce_bwd_tile_cols())


def _ce_backward(feats, w, b, labels, m, l, g):
    """K6: (dfeats bf16 [B, D], dW f32 [V, D], db f32 [V]) from the
    backward kernels."""
    _ce_kernel_checks(feats, w, b, labels, "fused_head_ce backward")
    dev = feats.device
    check_kernel_operands("fused_head_ce backward", dev, feats=feats, w=w, b=b, labels=labels,
                          m=m, l=l, g=g)
    bsz, d = feats.shape
    vocab = w.shape[0]
    geo = backward_geometry(bsz, d, vocab, _num_sms(dev.index))
    dlog = torch.empty((geo["vp"], geo["bs"]), dtype=torch.bfloat16, device=dev)
    part = torch.empty((geo["n_split"], geo["bp"], geo["dp"]), dtype=torch.float32, device=dev)
    dw = torch.empty((vocab, d), dtype=torch.float32, device=dev)
    db = torch.empty((vocab,), dtype=torch.float32, device=dev)
    dfeats = torch.empty((bsz, d), dtype=torch.bfloat16, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mpt_head_ce_bwd(
            feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(), m.data_ptr(),
            l.data_ptr(), g.data_ptr(), dlog.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), dfeats.data_ptr(), bsz, d, vocab, geo["n_ctas"], geo["n_split"],
            geo["tiles_per_split"], _build.stream(dev),
        )
    _build.check(code, "fused_head_ce backward")
    ce_backward_counter.add()
    return dfeats, dw, db


class _HeadCE(torch.autograd.Function):
    """The differentiable op. The forward rounds feats and W to bf16 once
    (the JAX wrapper's cast, outside its kernel) and keeps them, b, the
    labels and the rows' (m, l) for the backward. ``plain`` picks the
    plain forward and backward instead of the kernels."""

    @staticmethod
    def forward(ctx, feats, w, b, labels, plain):
        operands = (
            feats.detach().to(torch.bfloat16).contiguous(),
            w.detach().to(torch.bfloat16).contiguous(),
            b.detach().to(torch.float32).contiguous(),
            labels.to(torch.int32).contiguous(),
        )
        loss, m, l = (fused_head_ce_forward_reference if plain else _ce_forward)(*operands)
        ctx.save_for_backward(*operands, m, l)
        ctx.plain = plain
        ctx.dtypes = (feats.dtype, w.dtype, b.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        backward = fused_head_ce_backward_reference if ctx.plain else _ce_backward
        dfeats, dw, db = backward(*ctx.saved_tensors, g.float().contiguous())
        fd, wd, bd = ctx.dtypes
        return dfeats.to(fd), dw.to(wd), db.to(bd), None, None


def fused_head_ce(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-row cross-entropy of ``softmax(feats @ wᵀ + b)`` [B] f32, 0 where
    ``label < 0``, differentiable in feats, w [V, D] and b, without the
    [B, V] logits. The kernels for CUDA tensors (bf16 operands, D % 16 ==
    0), the plain forward and backward for CPU tensors."""
    check_shapes(feats, w, b, labels, "fused_head_ce")
    return _HeadCE.apply(feats, w, b, labels, _build.on_cpu(feats, "fused_head_ce"))


def fused_head_ce_reference(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """The plain version of :func:`fused_head_ce` on any device: the same
    function, roundings and gradients, in PyTorch with explicit logits."""
    check_shapes(feats, w, b, labels, "fused_head_ce")
    return _HeadCE.apply(feats, w, b, labels, True)
