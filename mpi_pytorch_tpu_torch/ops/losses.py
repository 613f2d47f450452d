"""Loss and metric ops (``mpi_pytorch_tpu/ops/losses.py``).

The loss is the integer-label softmax cross-entropy, computed in f32
whatever the compute dtype (softmax over 64 500 logits is where bf16
accumulates error), as the masked mean over rows with ``label >= 0``:
tail batches are padded to a fixed shape with label −1 rows, which count
nowhere.

Under a vocab-sharded head (``--mesh.model-parallel``) each rank of the
model axis holds a contiguous block of the classes' logits:
:func:`vocab_parallel_ce_sum` and :func:`vocab_parallel_argmax` compute
the same functions as :func:`masked_ce_sum` and the first-index argmax of
the whole logits, with all-reduces over that axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.parallel import collectives
from mpi_pytorch_tpu_torch.parallel.mesh import Axis


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


class _VocabParallelCE(torch.autograd.Function):
    """The masked CE sum over vocab shards: the row's global max, sum of
    exponentials and picked logit, each all-reduced over the model axis,
    ``Σ valid·(log Σ exp(z − max) + max − z_label)``. Every rank of the
    axis returns the same loss, so the backward is each rank's own
    ``(softmax − onehot)·valid`` on its shard, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, axis: Axis):
        z = logits.float()
        top = collectives.all_reduce(z.amax(dim=-1), "max", axis)
        e = torch.exp(z - top[:, None])
        total = collectives.all_reduce(e.sum(dim=-1), "sum", axis)
        local = (labels.long() - start)
        valid = labels >= 0
        mine = valid & (local >= 0) & (local < z.shape[-1])
        col = local.clamp(0, z.shape[-1] - 1)
        picked = torch.where(mine, z.gather(1, col[:, None]).squeeze(1), 0.0)
        picked = collectives.all_reduce(picked, "sum", axis)
        ctx.save_for_backward(e, total, col, mine, valid)
        ctx.dtype = logits.dtype
        return torch.sum((torch.log(total) + top - picked) * valid)

    @staticmethod
    def backward(ctx, grad):
        e, total, col, mine, valid = ctx.saved_tensors
        dz = e / total[:, None]
        dz.scatter_add_(1, col[:, None], -mine.to(dz.dtype)[:, None])
        dz *= (valid.to(dz.dtype) * grad)[:, None]
        return dz.to(ctx.dtype), None, None, None


def vocab_parallel_ce_sum(logits: torch.Tensor, labels: torch.Tensor, start: int,
                          axis: Axis) -> torch.Tensor:
    """:func:`masked_ce_sum` of the whole logits, from this rank's block
    ``logits`` [B, V/mp] of classes ``start … start + V/mp`` over the
    model axis ``axis``: in f32 on f32 or bf16 logits, as the JAX loss
    re-casts them, the same value on every rank of the axis."""
    if axis.size == 1:
        return masked_ce_sum(logits, labels)
    return _VocabParallelCE.apply(logits, labels, start, axis)


def vocab_parallel_argmax(logits: torch.Tensor, start: int, axis: Axis) -> torch.Tensor:
    """The first-index argmax (int64 [B]) of the whole logits from this
    rank's block over ``axis``: the largest value over the shards, then
    the smallest global index among the shards that hold it — the
    ``jnp.argmax`` tie order, also across a shard boundary. A NaN counts
    as the largest value, as in ``torch.argmax``. One all-gather."""
    idx = torch.argmax(logits, dim=-1)
    if axis.size == 1:
        return idx
    val = logits.gather(1, idx[:, None]).squeeze(1).double()
    both = collectives.all_gather(torch.stack([val, (idx + start).double()])[None], axis)
    vals, gidx = both[:, 0], both[:, 1]  # [mp, B] each
    nan = vals.isnan()
    best = torch.where(nan.any(dim=0), nan, vals == vals.amax(dim=0))
    inf = torch.full_like(gidx, float("inf"))
    return torch.where(best, gidx, inf).amin(dim=0).long()


def vocab_parallel_accuracy_count(logits: torch.Tensor, labels: torch.Tensor, start: int,
                                  axis: Axis) -> torch.Tensor:
    """:func:`accuracy_count` of the whole logits from this rank's block."""
    pred = vocab_parallel_argmax(logits, start, axis)
    return torch.sum((pred == labels) & (labels >= 0))
