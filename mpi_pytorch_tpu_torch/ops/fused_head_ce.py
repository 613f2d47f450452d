"""Streaming predict head: per-row cross-entropy and argmax of
``feats @ Wᵀ + b`` without storing the [B, V] logits.

Counterpart of ``mpi_pytorch_tpu/ops/fused_head_ce.py::head_predict``
(``_predict_kernel`` + ``online_predict_update``). Semantics carried over
exactly: argmax takes the first index attaining the max, loss is
``logsumexp(logits) − logits[label]``, and rows with ``label < 0`` (batch
padding) get loss 0.

Layout differs from the JAX function on purpose: W is ``[V, D]``
(K-major — a ``torch.nn.Linear`` weight as it stands), so the kernel
streams contiguous rows of it and the serving path keeps one bf16 copy
built once instead of re-casting per call. The training kernels of the
JAX module (``fused_head_ce``'s forward and backward) are not ported yet.

On a CUDA tensor :func:`head_predict` launches the kernel in
``csrc/fused_head_ce.cu`` or raises: bf16 feats and W through the tensor
cores, or f32 feats and W through the f32 variant (plain FFMA, no TF32:
an f32 model keeps an exact f32 head, as the JAX function's f32 kernel
does), with f32 bias and int32 labels. On a CPU tensor it runs
:func:`head_predict_reference`, the plain PyTorch version.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.ops import _build

# Launches of the CUDA kernel pair (one per head_predict call on the card):
# the bf16 variant, and the f32 variant.
counter = _build.LaunchCounter()
counter_f32 = _build.LaunchCounter()

# CTAs to aim for when choosing the number of vocab splits: about two per
# SM of an H100 (132 SMs), so that even batch 1 fills the card.
_TARGET_CTAS_PER_SM = 2


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


def split_geometry(rows: int, vocab: int, num_sms: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) for the kernel: enough vocab splits that
    the grid holds about ``2 × num_sms`` CTAs, with no empty split."""
    lib = _build.load_library()
    block_rows, block_v = lib.mpt_head_tile_rows(), lib.mpt_head_tile_vocab()
    row_tiles = -(-rows // block_rows)
    v_tiles = -(-vocab // block_v)
    want = max(1, -(-_TARGET_CTAS_PER_SM * num_sms // row_tiles))
    tiles_per_split = -(-v_tiles // min(want, v_tiles))
    return -(-v_tiles // tiles_per_split), tiles_per_split


def _check_shapes(feats, w, b, labels) -> None:
    if feats.dim() != 2 or w.dim() != 2 or w.shape[1] != feats.shape[1]:
        raise ValueError(
            f"head_predict takes feats [B, D] and w [V, D], got "
            f"{tuple(feats.shape)} and {tuple(w.shape)}"
        )
    if tuple(b.shape) != (w.shape[0],) or tuple(labels.shape) != (feats.shape[0],):
        raise ValueError(
            f"head_predict takes b [V] and labels [B], got {tuple(b.shape)} "
            f"and {tuple(labels.shape)}"
        )


def head_predict(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-row CE f32 [B], argmax int32 [B]) of ``softmax(feats @ wᵀ + b)``.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Forward only: the predictions path never backpropagates."""
    _check_shapes(feats, w, b, labels)
    if _build.on_cpu(feats, "head_predict"):
        return head_predict_reference(feats, w, b, labels)
    if torch.is_grad_enabled() and (feats.requires_grad or w.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "head_predict is forward-only; the training CE kernels "
            "(fused_head_ce forward/backward) are not ported yet"
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
    for name, t in (("feats", feats), ("w", w), ("b", b), ("labels", labels)):
        if not t.is_contiguous() or t.device != feats.device:
            raise ValueError(f"head_predict kernel needs {name} contiguous on {feats.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"head_predict kernel needs {name} 16-byte aligned")
    dev = feats.device
    n_split, tiles_per_split = split_geometry(bsz, vocab, _num_sms(dev.index))
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    pred = torch.empty((bsz,), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mpt_head_predict(
            feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            loss.data_ptr(), pred.data_ptr(), part_mlp.data_ptr(), part_arg.data_ptr(),
            bsz, d, vocab, n_split, tiles_per_split, _build.DTYPE_CODE[feats.dtype],
            _build.stream(dev),
        )
    _build.check(code, "head_predict")
    (counter if feats.dtype == torch.bfloat16 else counter_f32).add()
    return loss, pred
