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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the rows with ``label >= 0`` (≙ nn.CrossEntropyLoss),
    from f32 logits; 0 for a batch with no such row."""
    valid = labels >= 0
    per_example = F.cross_entropy(logits.float(), labels.clamp(min=0).long(), reduction="none")
    return torch.sum(per_example * valid) / torch.clamp(valid.sum(), min=1)


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
