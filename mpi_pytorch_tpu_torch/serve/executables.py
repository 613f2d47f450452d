"""The per-bucket predict set (``mpi_pytorch_tpu/serve/executables.py``):
one predict callable per batch bucket, built and warmed at start-up.

PyTorch runs eagerly, so there is nothing to compile ahead of time; what a
first request would otherwise pay for is the kernel library's build (on
first launch) and, with ``torch.backends.cudnn.benchmark`` on, cuDNN's
algorithm search for each new shape. ``warmup()`` runs every bucket once
on filler rows so both happen before traffic is accepted.

The fused head (``cfg.fused_head_eval``) streams argmax only, so it forces
``topk=1`` with a logged warning. Its weights are cut once here: W to the
compute dtype as a K-major [V, 512] copy and b to f32, reused by every
call (the JAX wrapper re-casts W per call; the rounding is the same).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mpi_pytorch_tpu_torch.evaluate import COMPUTE_DTYPES, head_weights, make_predict_step
from mpi_pytorch_tpu_torch.serve.batcher import parse_buckets


class BucketExecutables:
    """Warmed per-bucket predict callables over one eval-mode model."""

    def __init__(self, cfg, model: nn.Module, device: torch.device, *, logger=None):
        self.buckets = parse_buckets(cfg.parsed_serve_buckets())
        self.device = device
        self.topk = int(cfg.serve_topk)
        self.fused_head = bool(cfg.fused_head_eval)
        if self.fused_head and self.topk > 1:
            if logger is not None:
                logger.warning(
                    "--fused-head-eval streams argmax only: serving top-1 "
                    "instead of the requested serve_topk=%d", self.topk,
                )
            self.topk = 1
        compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # Host batches follow the loader contract: float32 rows arrive
        # normalized, uint8 rows are raw pixels normalized on the device.
        self.image_dtype = np.dtype(cfg.input_dtype)
        self.image_hw = tuple(cfg.image_size)
        self._model = model
        self._predict = make_predict_step(compute_dtype, self.fused_head, self.topk)
        self._head = head_weights(model, compute_dtype) if self.fused_head else None

    def place(self, images: np.ndarray, labels: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Host batch → device tensors. On CUDA the copy is queued on the
        current stream (asynchronous when ``images`` lies in pinned memory)."""
        img = torch.from_numpy(images)
        lbl = torch.from_numpy(labels.astype(np.int32, copy=False))
        return (
            img.to(self.device, non_blocking=True),
            lbl.to(self.device, non_blocking=True),
        )

    def __call__(self, bucket: int, device_batch) -> torch.Tensor:
        """Launch the bucket's predict step → device preds (asynchronous on
        CUDA). Metrics over the all-(−1) labels are discarded: serving
        reads the predictions."""
        images, labels = device_batch
        if images.shape[0] != bucket:
            raise ValueError(f"batch of {images.shape[0]} rows for bucket {bucket}")
        if self.fused_head:
            _, preds = self._predict(self._model, images, labels, self._head)
        else:
            _, preds = self._predict(self._model, images, labels)
        return preds

    def warmup(self) -> None:
        """Run every bucket once on filler rows and wait for it."""
        h, w = self.image_hw
        for bucket in self.buckets:
            images = np.zeros((bucket, h, w, 3), self.image_dtype)
            labels = np.full((bucket,), -1, np.int32)
            self(bucket, self.place(images, labels))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
