"""Inference construction and the batched predict step
(``mpi_pytorch_tpu/evaluate.py``: ``build_inference`` and
``_make_predict_step_impl``).

One predict step yields both the eval metrics and the per-image
predictions from the same forward. Two paths:

- plain: the model's logits, recast to f32, then argmax (``topk == 1``)
  or the top-k class indices, best first, equal logits in index order as
  ``jax.lax.top_k`` gives them (``ops.losses.topk_indices``);
- fused (``--fused-head-eval``): the model runs up to the pooled [B, D]
  features (``model.features``; every model's head is ``model.fc``), and
  ``ops.fused_head_ce.head_predict`` streams the head's weights
  computing per-row loss and argmax without the [B, V] logits.
  It streams argmax only, so ``topk > 1`` with the fused head raises.
  With ``int8_head`` (a model quantized by ``ops.quantize.quantize_model``
  with the head kept int8) the head is ``ops.quantize.head_predict_int8``.

The int8 predict sets quantize from the f32 weights
(:func:`float_state_dict`, taken before :func:`build_inference` casts), and
:func:`build_int8_inference` builds the quantized model from them.

Images come in NHWC (the JAX package's layout, and the server's host
batch layout); ``ingest_images`` normalizes uint8 pixels on the device and
the permute to NCHW is a view in channels_last memory.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.hardware import resolve_device
from mpi_pytorch_tpu_torch.models.registry import (
    init_weights,
    initialize_model,
    prepare_for_inference,
)
from mpi_pytorch_tpu_torch.ops.fused_head_ce import head_predict
from mpi_pytorch_tpu_torch.ops.losses import topk_indices
from mpi_pytorch_tpu_torch.ops.quantize import head_predict_int8, int8_head_operands, quantize_model
from mpi_pytorch_tpu_torch.train.step import COMPUTE_DTYPES, ingest_images, metrics_from_logits


def _f32_model(cfg: Config, state_dict: dict[str, torch.Tensor] | None) -> nn.Module:
    """The model on the CPU with its f32 weights: ``state_dict``, else a
    seeded random init from ``cfg.seed``."""
    model, _ = initialize_model(
        cfg.model_name, cfg.num_classes, fused_stem=cfg.fused_stem, attn_impl=cfg.attn_impl,
        qkv_fused=cfg.qkv_fused, image_size=cfg.image_size,
    )
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(state_dict)
    return model


def float_state_dict(
    cfg: Config, state_dict: dict[str, torch.Tensor] | None = None
) -> dict[str, torch.Tensor]:
    """The model's f32 weights on the CPU, before any cast to the compute
    dtype — ``state_dict`` in f32, else the seeded init of ``cfg.seed`` —
    which an int8 set quantizes and :func:`build_inference` can load."""
    return _f32_model(cfg, state_dict).state_dict()


def build_inference(
    cfg: Config,
    device: str | torch.device | None = None,
    state_dict: dict[str, torch.Tensor] | None = None,
) -> nn.Module:
    """The eval-mode model on ``device`` (default cuda): weights from
    ``state_dict`` (e.g. ``models.convert.from_flax_variables``), else a
    seeded random init from ``cfg.seed``."""
    cfg.validate_config()
    dev = resolve_device(device)
    return prepare_for_inference(_f32_model(cfg, state_dict), dev, COMPUTE_DTYPES[cfg.compute_dtype])


def build_int8_inference(
    cfg: Config,
    f32_state: dict[str, torch.Tensor],
    device: str | torch.device | None = None,
    *,
    keep_head_int8: bool,
    act_scale: float = 1.0,
) -> nn.Module:
    """The post-training int8 eval-mode model on ``device``, quantized from
    the f32 weights ``f32_state`` (``quantize_model``), then prepared: int8
    weights resident, batchnorm and biases f32."""
    cfg.validate_config()
    dev = resolve_device(device)
    model = quantize_model(_f32_model(cfg, f32_state), keep_head_int8=keep_head_int8,
                           act_scale=act_scale)
    return prepare_for_inference(model, dev, COMPUTE_DTYPES[cfg.compute_dtype])


def head_weights(model: nn.Module, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The head's (W [V, D] in ``dtype``, b f32 [V]) as the streaming head
    takes them: the kernel matmuls in the feature dtype, so a bf16 model
    gets one bf16 copy of W. Cut once by the caller and reused per call."""
    fc = model.fc
    return (
        fc.weight.detach().to(dtype).contiguous(),
        fc.bias.detach().to(torch.float32).contiguous(),
    )


def _fused_metrics(loss: torch.Tensor, preds: torch.Tensor, labels: torch.Tensor):
    valid = labels >= 0
    return {
        "loss": torch.sum(loss),  # the head zeroes padding rows
        "correct": torch.sum((preds == labels) & valid),
        "count": torch.sum(valid.to(torch.int32)),
    }


def make_predict_step(
    compute_dtype: torch.dtype, fused_head: bool = False, topk: int = 1,
    int8_head: bool = False,
) -> Callable:
    """``predict(model, images, labels[, head]) -> (metrics, preds)``.

    ``images`` NHWC (uint8 raw pixels or normalized floats), ``labels``
    int32 with −1 on padding rows. ``preds`` is int32 [B] (``topk == 1``)
    or [B, topk]. The fused step takes an optional prepared ``head`` from
    :func:`head_weights` (or ``ops.quantize.int8_head_operands`` with
    ``int8_head``); without it the head's operands are cut per call."""
    if fused_head and topk > 1:
        raise ValueError(
            "the fused head (head_predict) streams argmax only; top-k needs "
            "the plain predict path"
        )
    if int8_head and not fused_head:
        raise ValueError(
            "int8_head selects the fused int8 kernel variant and requires "
            "fused_head=True; the plain int8 path is just the plain predict "
            "step over a quantized model (ops/quantize.quantize_model)"
        )

    def model_input(images: torch.Tensor) -> torch.Tensor:
        return ingest_images(images, compute_dtype).permute(0, 3, 1, 2)

    if not fused_head:

        @torch.no_grad()
        def predict(model, images, labels):
            logits = model(model_input(images)).float()
            if topk > 1:
                preds = topk_indices(logits, topk)
            else:
                preds = torch.argmax(logits, dim=-1).to(torch.int32)
            return metrics_from_logits(logits, labels), preds

        return predict

    if int8_head:

        @torch.no_grad()
        def predict_fused_int8(model, images, labels, head=None):
            feats = model.features(model_input(images)).contiguous()
            h = head if head is not None else int8_head_operands(model)
            loss, preds = head_predict_int8(feats, h.w_q, h.b, labels, None, h.act_scale, h.scale_v)
            return _fused_metrics(loss, preds, labels), preds

        return predict_fused_int8

    @torch.no_grad()
    def predict_fused(model, images, labels, head=None):
        feats = model.features(model_input(images)).contiguous()
        w, b = head if head is not None else head_weights(model, feats.dtype)
        loss, preds = head_predict(feats, w, b, labels)
        return _fused_metrics(loss, preds, labels), preds

    return predict_fused
