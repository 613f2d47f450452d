"""Loss and metric ops (``mpi_pytorch_tpu/ops/losses.py``).

The loss is the integer-label softmax cross-entropy, computed in f32
whatever the compute dtype (softmax over 64 500 logits is where bf16
accumulates error), as the masked mean over rows with ``label >= 0``:
tail batches are padded to a fixed shape with label −1 rows, which count
nowhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The CE summed over the rows with ``label >= 0``, from f32 logits."""
    per_example = F.cross_entropy(logits.float(), labels.clamp(min=0).long(), reduction="none")
    return torch.sum(per_example * (labels >= 0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the rows with ``label >= 0`` (≙ nn.CrossEntropyLoss),
    from f32 logits; 0 for a batch with no such row."""
    return masked_ce_sum(logits, labels) / torch.clamp((labels >= 0).sum(), min=1)


def classification_loss(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The training loss of a single-headed classifier (the JAX function
    also takes inception's ``(logits, aux)`` pair, which no ported model
    returns)."""
    return cross_entropy(outputs, labels)


def accuracy_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Correct top-1 predictions; padding rows (label < 0) never count."""
    return torch.sum((torch.argmax(logits, dim=-1) == labels) & (labels >= 0))


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """Non-padding rows in a batch."""
    return torch.sum((labels >= 0).to(torch.int32))


def topk_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [..., k]: the indices of each row's k largest logits in
    ``jax.lax.top_k``'s order — by value descending, equal values by index
    ascending, so column 0 is the first-index argmax. ``lax.top_k`` orders
    floats totally (−NaN < −inf < … < −0.0 < +0.0 < … < +inf < +NaN: a
    +0.0 comes before an earlier −0.0), and so does this.

    ``torch.topk`` leaves the order of equal values unspecified, and bf16
    logits (8 significant bits) tie often. So the selection runs over one
    int64 key a logit: its f32 bits mapped to an order-preserving int32 in
    the high half, ``0xFFFFFFFF − column`` in the low half. The keys are
    distinct, and a top-k over them is a selection, not a full sort."""
    bits = logits.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(logits.shape[-1], device=logits.device, dtype=torch.int64)
    return torch.topk((ordered << 32) | (0xFFFFFFFF - col), k, dim=-1).indices.to(torch.int32)
