"""The eval subset of ``mpi_pytorch_tpu/train/step.py``: device-side image
ingest and the masked eval metrics. The train step comes with the training
slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD


def ingest_images(images: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Device-side image ingest, keyed on the batch dtype:

    - uint8 batches are raw pixels (``input_dtype='uint8'``, 4× less
      host→device traffic than f32): the ImageNet normalize runs on the
      device in f32 with the op order of ``pipeline.normalize_image``
      (``/255``, ``−mean``, ``/std``), then casts to the compute dtype;
    - float batches were normalized on the host and are just cast."""
    if images.dtype == torch.uint8:
        x = images.to(torch.float32) / 255.0
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
