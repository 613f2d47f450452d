"""The train and eval steps of ``mpi_pytorch_tpu/train/step.py``:
device-side image ingest, the train step (forward in train mode, masked
CE, backward, gradient sync, global grad norm, optimizer update, optional
skip of a non-finite step) and the eval step (f32 logits → masked
metrics).

PyTorch runs eagerly, so there is no jit; a step is a plain function over
the mutable :class:`~mpi_pytorch_tpu_torch.train.state.TrainState`. Images
arrive NHWC (the loader's layout); the permute to NCHW is a view in
channels_last memory.

Data parallelism (one rank per GPU, ``parallel/distributed.py``), in the
JAX package's two modes; each rank passes its own rows of the global
batch:

- **auto** (default, JAX ``make_train_step`` on a data mesh): batchnorm
  over the global batch (``models.common.set_batchnorm_sync``), the global
  valid count all-reduced before the backward, each rank's loss its masked
  CE sum over that count — its share of the global mean — and the
  gradients summed over the ranks after the backward: the gradient of the
  count-weighted global mean.
- **spmd** (``--spmd-mode``, JAX ``make_spmd_train_step``): each rank's
  loss is its local masked mean with its local batchnorm statistics
  (global with ``sync_batchnorm``), the gradients averaged over the ranks
  however many valid rows each held (``collectives.avg_grads``, the
  reference's ``mpi_avg_grads``), and the running statistics averaged
  after the forward.

In both the reported loss is the count-weighted global mean, ``correct``
and ``count`` are summed over the ranks, ``grad_norm`` is the synced
gradients', and the skip verdict reads only synced values, so every rank
takes the same branch. For one rank every collective is the identity and
the step computes what the one-process step always computed, bit for bit
(``tests/test_torch_dp_step.py``).
Gradient accumulation (``accum_steps > 1``) is not ported yet.

The device cache (``--device-cache``, JAX ``make_cached_train_step``,
``make_scanned_epoch``, ``make_cached_eval_step``): the training set lives
in device memory (``trainer.build_device_cache``) and each step gathers
its batch by index (:func:`_gather_batch`), then runs the auto step's
body.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from mpi_pytorch_tpu_torch.models.common import BatchNorm
from mpi_pytorch_tpu_torch.ops.losses import accuracy_count, masked_ce_sum, valid_count
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.train.state import TrainState

# ``Config.compute_dtype`` → torch dtype.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ingest_images(images: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Device-side image ingest, keyed on the batch dtype:

    - uint8 batches are raw pixels (``input_dtype='uint8'``, 4× less
      host→device traffic than f32): the ImageNet normalize runs on the
      device in f32 with the op order of ``pipeline.normalize_image``
      (``/255``, ``−mean``, ``/std``, each a correctly rounded division —
      PyTorch on CUDA turns a division by a Python scalar into a multiply
      by its reciprocal, so 255 goes as a tensor filled on the device),
      then casts to the compute dtype;
    - float batches were normalized on the host and are just cast."""
    if images.dtype == torch.uint8:
        x = images.to(torch.float32) / torch.full((), 255.0, device=images.device)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
        return x.to(compute_dtype)
    return images.to(compute_dtype)


def metrics_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """loss-sum / correct / count from f32 logits; ``labels < 0`` mark
    padding rows and count nowhere."""
    valid = labels >= 0
    per_ex = F.cross_entropy(logits, labels.clamp(min=0).long(), reduction="none")
    return {
        "loss": torch.sum(per_ex * valid),
        "correct": torch.sum((torch.argmax(logits, dim=-1) == labels) & valid),
        "count": torch.sum(valid.to(torch.int32)),
    }


def grad_norm(model: nn.Module) -> torch.Tensor:
    """The global L2 norm over every parameter's gradient, in f32
    (``optax.global_norm``), frozen parameters included."""
    grads = [p.grad.float() for p in model.parameters() if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [
        t for m in model.modules() if isinstance(m, BatchNorm)
        for t in (m.running_mean, m.running_var)
    ]


def make_train_step(compute_dtype: torch.dtype, bad_step_skip: bool = False) -> Callable:
    """The auto-mode step (see the module docstring and :func:`_make_step`)."""
    return _make_step(compute_dtype, bad_step_skip, spmd=False)


def make_spmd_train_step(compute_dtype: torch.dtype, bad_step_skip: bool = False) -> Callable:
    """The spmd-mode step (see the module docstring and :func:`_make_step`)."""
    return _make_step(compute_dtype, bad_step_skip, spmd=True)


def _make_step(compute_dtype: torch.dtype, bad_step_skip: bool, spmd: bool) -> Callable:
    """``step(state, images, labels) -> metrics``: one optimizer update on
    this rank's rows (the whole batch for one process), in auto mode or,
    with ``spmd``, in spmd mode. The model's batchnorms must already take
    the mode's statistics (``set_batchnorm_sync``: on in auto mode,
    ``sync_batchnorm`` in spmd mode).

    ``metrics`` holds 0-d device tensors ``loss`` (the masked mean CE over
    the global batch), ``correct``, ``count`` and ``grad_norm``, plus
    ``skipped`` (0/1) with ``bad_step_skip``. Nothing here waits for the
    device, except the skip policy, which must read the verdict on the
    host, and the collectives of a world of more than one rank.

    ``bad_step_skip`` (``--bad-step-policy skip``): a step whose loss or
    grad norm is not finite changes nothing — the state is bit-identical to
    before it, as the JAX step's whole-state select leaves it. The verdict
    is read before the update, so the parameters, the optimizer's moments
    and the step counter are never touched; but the forward has already
    moved the batchnorm running statistics (torch updates them in place
    during the forward), so those are restored from a copy taken before
    it."""

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model = state.model
        model.train()
        saved = [t.clone() for t in _running_stats(model)] if bad_step_skip else None
        model.zero_grad(set_to_none=True)
        logits = model(ingest_images(images, compute_dtype).permute(0, 3, 1, 2))
        count = valid_count(labels)
        ce_sum = masked_ce_sum(logits, labels)
        if spmd:
            # The JAX step pmeans its new batch stats after the forward.
            collectives.all_reduce_(_running_stats(model), "mean")
        # The global CE sum, valid count and correct count, all-reduced
        # before the backward.
        f32 = ce_sum.dtype
        sums = collectives.all_reduce(torch.stack([
            ce_sum.detach(), count.to(f32), accuracy_count(logits.detach(), labels).to(f32)]))
        global_count = sums[1].to(torch.int32)
        # spmd: the local masked mean. auto: this rank's share of the
        # global mean, its CE sum over the global valid count.
        loss = ce_sum / torch.clamp(count if spmd else global_count, min=1)
        loss.backward()
        (collectives.avg_grads if spmd else collectives.sum_grads)(model)
        metrics = {
            "loss": sums[0] / torch.clamp(sums[1], min=1),
            "correct": sums[2].to(torch.int64),
            "count": global_count,
            "grad_norm": grad_norm(model),
        }
        if bad_step_skip:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"]))
            metrics["skipped"] = torch.tensor(int(not ok), dtype=torch.int32)
            if not ok:
                with torch.no_grad():
                    for t, old in zip(_running_stats(model), saved):
                        t.copy_(old)
                model.zero_grad(set_to_none=True)
                return metrics
        state.set_learning_rate()
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step


def make_eval_step(compute_dtype: torch.dtype) -> Callable:
    """``eval_step(model, images, labels) -> {loss (sum), correct, count}``:
    the eval-mode forward, logits recast to f32, masked metrics. The
    caller puts the model in eval mode."""

    @torch.no_grad()
    def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor):
        logits = model(ingest_images(images, compute_dtype).permute(0, 3, 1, 2)).float()
        return metrics_from_logits(logits, labels)

    return eval_step


def _gather_batch(dataset: torch.Tensor, labels_all: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, compute_dtype: torch.dtype):
    """This rank's rows of one batch of the device cache, gathered by index
    on the device: the one ingest of the cached train step, the scanned
    epoch and the cached eval step (JAX ``_gather_batch`` with
    ``_sharded_cache_take``), so none can drift from the others.

    ``idx`` ([B] int32) and ``valid`` ([B] bool) name the GLOBAL batch, the
    same on every rank. One rank holds every row: an index select. With N
    ranks each holds a contiguous 1/N of the rows
    (``trainer.build_device_cache``): each takes the rows it owns for the
    whole batch, writes literal zeros where it owns none, and the sum over
    the ranks is the batch — exact in uint8 and f32 alike, since each row
    has one owner and every other term is a zero. The rank keeps its own
    rank-major slice of B/N rows, as JAX's ``psum`` and the data-axis
    shard give it. Labels are ``labels_all[idx]``, −1 where not ``valid``.

    Returns (images [B/N, H, W, 3] ingested into ``compute_dtype``, labels
    [B/N] int32)."""
    world = collectives.num_processes()
    idx = idx.long()
    labels = torch.where(valid, labels_all[idx], -1)
    if world == 1:
        raw = dataset.index_select(0, idx)
    else:
        rank, per = distributed.rank(), dataset.shape[0]
        local = idx - rank * per
        owned = ((local >= 0) & (local < per)).view(-1, *(1,) * (dataset.dim() - 1))
        rows = dataset.index_select(0, local.clamp(0, per - 1))
        rows = collectives.all_reduce(torch.where(owned, rows, torch.zeros_like(rows)))
        mine = slice(rank * idx.shape[0] // world, (rank + 1) * idx.shape[0] // world)
        raw, labels = rows[mine], labels[mine]
    return ingest_images(raw, compute_dtype), labels


def make_cached_train_step(compute_dtype: torch.dtype, bad_step_skip: bool = False) -> Callable:
    """``cached_step(state, dataset, labels_all, idx, valid) -> metrics``:
    the auto-mode step — :func:`_make_step`'s body itself, so the two
    cannot drift — on the batch :func:`_gather_batch` takes from the
    device cache. The host sends a ``[B]`` index and mask a step, not
    pixels. Auto mode only: ``validate_config`` refuses the cache in spmd
    mode, as the JAX package does."""
    step = _make_step(compute_dtype, bad_step_skip, spmd=False)

    def cached_step(state: TrainState, dataset, labels_all, idx, valid):
        return step(state, *_gather_batch(dataset, labels_all, idx, valid, compute_dtype))

    return cached_step


def make_scanned_epoch(compute_dtype: torch.dtype, bad_step_skip: bool = False) -> Callable:
    """``epoch_fn(state, dataset, labels_all, idx_all, valid_all) ->
    metrics``: every step of an epoch from device-resident ``[n_steps, B]``
    index and mask tensors (``--scan-epoch``, JAX ``make_scanned_epoch``).
    ``metrics`` maps ``loss``, ``correct``, ``count`` and ``grad_norm``
    (and ``skipped`` with ``bad_step_skip``) to ``[n_steps]`` tensors.

    JAX runs the epoch as one ``lax.scan``: one dispatch an epoch.
    PyTorch has no scan, so the steps are still launched from Python one
    by one, each :func:`make_cached_train_step`'s step — the same
    operations on the same batches, so the same bits. What carries over is
    that nothing reads the device between steps: the host queues the whole
    epoch and the caller reads its metrics once, at the end. Under
    ``bad_step_skip`` each step still waits once, where it reads its
    verdict on the host, as the per-step path does; that keeps the state
    after every step the JAX step's. One dispatch an epoch (a CUDA graph)
    is ROADMAP A12's."""
    step = make_cached_train_step(compute_dtype, bad_step_skip)

    def epoch_fn(state: TrainState, dataset, labels_all, idx_all, valid_all):
        per_step = [step(state, dataset, labels_all, idx, valid)
                    for idx, valid in zip(idx_all, valid_all)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return epoch_fn


def make_cached_eval_step(compute_dtype: torch.dtype) -> Callable:
    """``cached_eval_step(model, dataset, labels_all, idx, valid) ->
    {loss (sum), correct, count}``: :func:`make_eval_step`'s forward and
    metrics on the batch :func:`_gather_batch` takes from the device cache
    (JAX ``make_cached_eval_step``); this rank's rows only. The caller
    puts the model in eval mode."""
    eval_step = make_eval_step(compute_dtype)

    @torch.no_grad()
    def cached_eval_step(model: nn.Module, dataset, labels_all, idx, valid):
        return eval_step(model, *_gather_batch(dataset, labels_all, idx, valid, compute_dtype))

    return cached_eval_step
