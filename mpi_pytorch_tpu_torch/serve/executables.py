"""The per-bucket predict set (``mpi_pytorch_tpu/serve/executables.py``):
one predict callable per batch bucket, built and warmed at start-up.

PyTorch runs eagerly, so there is nothing to compile ahead of time; what a
first request would otherwise pay for is the kernel library's build (on
first launch) and, with ``torch.backends.cudnn.benchmark`` on, cuDNN's
algorithm search for each new shape. ``warmup()`` runs every bucket once
on filler rows so both happen before traffic is accepted.

The fused head (``cfg.fused_head_eval``) streams argmax only, so it forces
``topk=1`` with a logged warning; a model with no dense head
(squeezenet1_0) serves through the plain step, also with a warning. Its weights are cut once here: W to the
compute dtype as a K-major [V, D] copy and b to f32, reused by every
call (the JAX wrapper re-casts W per call; the rounding is the same).

``precision="int8"`` builds the post-training int8 model from the f32
weights (``evaluate.build_int8_inference``): under the fused head with the
head kept int8 and its activation scale calibrated on the seeded sample
batch through the float model, else with every weight dequantized per call
and an activation scale of 1.0 that nothing reads. The int8 head's
operands (W int8 [V, D], b, ``scale_v``) are cut once per set. A server
holding both sets switches between them without building anything
(``InferenceServer.set_precision``); :func:`measure_parity_top1` stamps
their start-up agreement.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mpi_pytorch_tpu_torch.evaluate import (
    COMPUTE_DTYPES,
    build_int8_inference,
    fused_head_applies,
    head_weights,
    make_predict_step,
)
from mpi_pytorch_tpu_torch.ops.quantize import (
    Int8Head,
    calibrate_head_act_scale,
    calibration_batch,
    int8_head_operands,
)
from mpi_pytorch_tpu_torch.serve.batcher import parse_buckets


class BucketExecutables:
    """Warmed per-bucket predict callables over one eval-mode model, in one
    precision. ``model`` is the float eval-mode model; an int8 set also
    takes ``f32_state``, the f32 weights it quantizes (``model`` then only
    calibrates the head's activation scale)."""

    def __init__(
        self, cfg, model: nn.Module, device: torch.device, *, logger=None,
        precision: str = "bf16", f32_state: dict[str, torch.Tensor] | None = None,
    ):
        if precision not in ("bf16", "int8"):
            raise ValueError(
                f"precision must be 'bf16' or 'int8', got {precision!r} "
                "(a set holds ONE precision; serve_precision='both' builds "
                "two sets)"
            )
        self.precision = precision
        self.buckets = parse_buckets(cfg.parsed_serve_buckets())
        self.device = device
        self.topk = int(cfg.serve_topk)
        self.fused_head = fused_head_applies(cfg, model, logger)
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
        int8 = precision == "int8"
        if int8:
            if f32_state is None:
                raise ValueError(
                    "an int8 set quantizes the f32 weights: pass f32_state "
                    "(evaluate.float_state_dict)"
                )
            act_scale = (
                calibrate_head_act_scale(model, calibration_batch(cfg), compute_dtype)
                if self.fused_head else 1.0
            )
            model = build_int8_inference(cfg, f32_state, device, keep_head_int8=self.fused_head,
                                         act_scale=act_scale)
        self._model = model
        self._predict = make_predict_step(compute_dtype, self.fused_head, self.topk,
                                          int8_head=int8 and self.fused_head)
        self._head = None
        if self.fused_head:
            self._head = int8_head_operands(model) if int8 else head_weights(model, compute_dtype)

    @property
    def model(self) -> nn.Module:
        """The eval-mode model this set runs (the int8 one for an int8 set)."""
        return self._model

    def resident_bytes(self) -> int:
        """Bytes of every tensor this set keeps on its device: the model's
        parameters and buffers and the cut head, each storage once."""
        head = self._head
        if isinstance(head, Int8Head):
            head = (head.w_q, head.b, head.scale_v)
        tensors = [*self._model.parameters(), *self._model.buffers(), *(head or ())]
        seen, total = set(), 0
        for t in tensors:
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total

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


def measure_parity_top1(exe_ref: BucketExecutables, exe_q: BucketExecutables, *, samples: int = 32,
                        seed: int = 0) -> float:
    """Top-1 agreement between two warmed predict sets on a fixed seeded
    sample through the serve path (place → bucket step → readback), at the
    largest bucket, ``ceil(samples / bucket)`` batches of it: the start-up
    parity stamp of a server holding both precisions."""
    bucket = exe_ref.buckets[-1]
    h, w = exe_ref.image_hw
    rng = np.random.default_rng(seed)
    agree = total = 0
    for _ in range(max(1, -(-samples // bucket))):
        if exe_ref.image_dtype == np.uint8:
            images = rng.integers(0, 256, size=(bucket, h, w, 3)).astype(np.uint8)
        else:
            # Float contract: rows arrive normalized, so a unit gaussian
            # sample is in-distribution.
            images = rng.normal(size=(bucket, h, w, 3)).astype(np.float32)
        labels = np.full((bucket,), -1, np.int32)
        p_ref, p_q = (
            exe(bucket, exe.place(images, labels)).cpu().numpy().reshape(bucket, -1)
            for exe in (exe_ref, exe_q)
        )
        agree += int((p_ref[:, 0] == p_q[:, 0]).sum())
        total += bucket
    return round(agree / total, 4)
