"""The train and eval steps of ``mpi_pytorch_tpu/train/step.py`` on one
device: device-side image ingest, the train step (forward in train mode,
masked CE, backward, global grad norm, optimizer update, optional skip of
a non-finite step) and the eval step (f32 logits → masked metrics).

PyTorch runs eagerly, so there is no jit; a step is a plain function over
the mutable :class:`~mpi_pytorch_tpu_torch.train.state.TrainState`. Images
arrive NHWC (the loader's layout); the permute to NCHW is a view in
channels_last memory. Gradient accumulation (``accum_steps > 1``) waits
for the data-parallel slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from mpi_pytorch_tpu_torch.models.common import BatchNorm
from mpi_pytorch_tpu_torch.ops.losses import accuracy_count, classification_loss, valid_count
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
    """``step(state, images, labels) -> metrics``: one optimizer update.

    ``metrics`` holds 0-d device tensors ``loss`` (the masked mean CE),
    ``correct``, ``count`` and ``grad_norm``, plus ``skipped`` (0/1) with
    ``bad_step_skip``. Nothing here waits for the device, except the skip
    policy, which must read the verdict on the host.

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
        loss = classification_loss(logits, labels)
        loss.backward()
        metrics = {
            "loss": loss.detach(),
            "correct": accuracy_count(logits.detach(), labels),
            "count": valid_count(labels),
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
