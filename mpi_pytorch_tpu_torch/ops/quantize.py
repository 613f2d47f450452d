"""Post-training int8 quantization for serving, and the fused int8 predict
head (``mpi_pytorch_tpu/ops/quantize.py``).

Three layers, as in the JAX module:

1. **Per-channel weight quantization** (:func:`quantize_per_channel`):
   int8 values and an f32 scale per OUTPUT channel, ``scale = max|w|/127``
   (floored at 1e-8) over the channel's fan-in, ``q = clamp(round(w /
   scale), −127, 127)`` with an IEEE division and rounding half to even.
   The port's weights are ``[out, in, kh, kw]`` and ``[out, in]``, so the
   scale lies on dim 0 where the JAX kernels ``[kh, kw, in, out]`` and
   ``[in, out]`` carry it last: after the layout transpose the int8 tensors
   and scales are the same bits.
2. **A quantized model** (:func:`quantize_model`, the counterpart of
   ``quantize_params`` + ``quantize_state``): every convolution and dense
   weight becomes a resident int8 tensor plus its scale, dequantized per
   call — ``q.float() * scale``, then the compute dtype — which rounds where
   the JAX path rounds (``dequantize_params`` to f32, then flax's cast).
   Biases and batchnorm stay f32. It quantizes the f32 master weights: a
   model already cast to the compute dtype would quantize other numbers.
   With ``keep_head_int8`` the classifier head ``fc`` stays int8 ``[V, D]``
   for the fused kernel, with the activation scale calibrated on a seeded
   sample batch (:func:`calibrate_head_act_scale`).
3. **The fused int8 head** (:func:`head_predict_int8`): ``head_predict``'s
   int8 sibling. On a CUDA tensor it launches the kernels in
   ``csrc/head_predict_tc.cu`` (feats quantized as
   :func:`quantize_activations` does, then wgmma int8 × int8 products with
   exact int32 sums, ``float(acc)·scale_v + b`` as two roundings and the
   same online softmax and first-index argmax) or raises; on a CPU tensor it runs
   :func:`head_predict_int8_reference`, whose exact integer product gives
   the kernel's logits bit for bit.

The vits are refused by name: their q/k/v are flax ``DenseGeneral``
kernels ``[D, H, Dh]`` whose scale lies on ``Dh``, shared across heads —
a layout this slice does not carry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.models.common import SameConv2d, same_padding
from mpi_pytorch_tpu_torch.models.vit import VisionTransformer
from mpi_pytorch_tpu_torch.ops import _build
from mpi_pytorch_tpu_torch.ops.fused_head_ce import (
    _num_sms,
    check_kernel_operands,
    ROUTE_CODE,
    check_shapes,
    tc_geometry,
)
from mpi_pytorch_tpu_torch.train.step import ingest_images

# Launches of the int8 head kernel (one per head_predict_int8 call on the
# card), on its resident-feats route and on its streamed route (D = 4096).
counter = _build.LaunchCounter("quantize.counter")
counter_wide = _build.LaunchCounter("quantize.counter_wide")


def _f32(x) -> float:
    """``x`` (a Python number or a one-element tensor) rounded to f32, as a
    Python float — what a weak-typed scalar becomes in the JAX
    expressions."""
    return float(np.float32(float(x)))


def _div(x: torch.Tensor, y) -> torch.Tensor:
    """``x / y`` as an IEEE division on every device: on CUDA, PyTorch turns
    a division by a Python scalar into a multiply by its reciprocal, so the
    divisor goes as a tensor on ``x``'s device."""
    return torch.div(x, torch.as_tensor(y, dtype=torch.float32, device=x.device))


def quantize_per_channel(w: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``w`` → (int8 values, f32 scale per channel of ``axis``), symmetric
    over [−127, 127]. All-zero channels get scale 1e-8/127 and exact zeros."""
    w = w.detach().float()
    axis %= w.dim()
    reduce = [i for i in range(w.dim()) if i != axis]
    amax = w.abs().amax(dim=reduce) if reduce else w.abs()
    scale = _div(amax.clamp_min(1e-8), 127.0)
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.round(w / scale.view(shape)).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize(
    q: torch.Tensor, scale: torch.Tensor, axis: int = 0, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """int8 values + per-channel scale → a ``dtype`` tensor."""
    shape = [1] * q.dim()
    shape[axis % q.dim()] = -1
    return q.to(dtype) * scale.view(shape).to(dtype)


def quantize_activations(x: torch.Tensor, act_scale) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clamp(round(x / act_scale), −127,
    127)`` in f32; out-of-range values saturate."""
    return torch.round(_div(x.float(), _f32(act_scale))).clamp(-127, 127).to(torch.int8)


# --------------------------------------------------------------------------
# the quantized model
# --------------------------------------------------------------------------


class QuantizedConv2d(nn.Module):
    """A convolution whose weight is resident as int8 ``q`` [out, in, kh, kw]
    with an f32 per-output-channel ``scale``, dequantized per call."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        if conv.padding_mode != "zeros":
            raise ValueError(f"QuantizedConv2d takes zero padding, got {conv.padding_mode!r}")
        q, scale = quantize_per_channel(conv.weight)
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", None if conv.bias is None else conv.bias.detach().float())
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        # flax 'SAME' (squeezenet's stem): its uneven padding, computed per call.
        self.same = isinstance(conv, SameConv2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.same:
            x = same_padding(x, tuple(self.q.shape[2:]), self.stride)
        return F.conv2d(x, dequantize(self.q, self.scale).to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class QuantizedDense(nn.Module):
    """A dense layer whose weight is resident as int8 ``q`` [out, in] with an
    f32 per-output ``scale``; the forward dequantizes it per call. With an
    ``act_scale`` it is a head kept int8 for the fused kernel
    (:func:`int8_head_operands`), ``act_scale`` quantizing its input."""

    def __init__(self, dense: nn.Linear, act_scale: float | None = None):
        super().__init__()
        q, scale = quantize_per_channel(dense.weight)
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", dense.bias.detach().float())
        self.register_buffer(
            "act_scale", None if act_scale is None else torch.tensor(act_scale, dtype=torch.float32)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, dequantize(self.q, self.scale).to(x.dtype), self.bias.to(x.dtype))


def head_module(model: nn.Module) -> nn.Module | None:
    """The classifier head the fused int8 kernel can take: ``model.fc`` when
    it is a dense layer (2-D weight), else None — a conv-shaped head
    (squeezenet1_0's ``head``) dequantizes like any convolution (the JAX
    ``head_kernel_key``)."""
    fc = getattr(model, "fc", None)
    return fc if isinstance(fc, (nn.Linear, QuantizedDense)) else None


def quantize_model(
    model: nn.Module, *, keep_head_int8: bool = False, act_scale: float = 1.0
) -> nn.Module:
    """Replace every convolution and dense layer of ``model`` by its int8
    twin, in place, and return ``model``. Its weights must be the f32
    masters (raises otherwise). ``keep_head_int8`` keeps the dense head
    ``fc`` int8 for the fused kernel, with ``act_scale``; a conv-shaped head
    is quantized as a convolution either way."""
    if isinstance(model, VisionTransformer):
        raise NotImplementedError(
            "int8 quantization of vit_s16/vit_b16 is not ported: their q/k/v "
            "are flax DenseGeneral kernels [D, H, Dh] whose scale lies on Dh, "
            "shared across heads"
        )
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(
                f"quantize_model quantizes the f32 master weights; {name} is "
                f"{p.dtype} (quantize before prepare_for_inference casts)"
            )
    head = head_module(model)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Conv2d):
                setattr(parent, name, QuantizedConv2d(child))
            elif isinstance(child, nn.Linear):
                keep = keep_head_int8 and child is head
                setattr(parent, name, QuantizedDense(child, act_scale if keep else None))
    return model


def calibration_batch(cfg) -> np.ndarray:
    """The seeded calibration / parity sample: ``cfg.quantize_calib`` raw
    uint8 images from ``cfg.seed`` — the JAX package's bytes."""
    h, w = cfg.image_size
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, 256, size=(cfg.quantize_calib, h, w, 3)).astype(np.uint8)


@torch.no_grad()
def calibrate_head_act_scale(model: nn.Module, images: np.ndarray, compute_dtype: torch.dtype) -> float:
    """The int8 activation scale of the head's input, measured through the
    FLOAT model in the compute dtype: ``max(max|feats|, 1e-6) / 127`` (in
    Python, then f32 where it is stored). 1.0 when the model has no dense
    head."""
    if head_module(model) is None:
        return 1.0
    dev = next(model.parameters()).device
    x = ingest_images(torch.from_numpy(images).to(dev), compute_dtype).permute(0, 3, 1, 2)
    amax = float(model.features(x).float().abs().max())
    return max(amax, 1e-6) / 127.0


# --------------------------------------------------------------------------
# the fused int8 head
# --------------------------------------------------------------------------


def combined_scale(w_scale: torch.Tensor, act_scale) -> torch.Tensor:
    """``scale_v = w_scale · act_scale`` in f32, the dequantizing multiplier
    of each logit (cut once per predict set)."""
    return w_scale.float() * _f32(act_scale)


@dataclasses.dataclass(frozen=True)
class Int8Head:
    """What the fused int8 head reads, cut once from a kept-int8 head:
    W int8 [V, D], b f32 [V], ``scale_v`` f32 [V] and the f32 act scale."""

    w_q: torch.Tensor
    b: torch.Tensor
    scale_v: torch.Tensor
    act_scale: float


def int8_head_operands(model: nn.Module) -> Int8Head:
    """The fused int8 head's operands of a model quantized with
    ``keep_head_int8``; raises for any other model."""
    fc = head_module(model)
    if not isinstance(fc, QuantizedDense) or fc.act_scale is None:
        raise ValueError(
            "the fused int8 head needs a dense head kept int8 "
            "(quantize_model(..., keep_head_int8=True))"
        )
    act = float(fc.act_scale)
    return Int8Head(fc.q.contiguous(), fc.bias.contiguous(), combined_scale(fc.scale, act).contiguous(), act)


def int8_logits(
    feats: torch.Tensor, w_q: torch.Tensor, b: torch.Tensor, scale_v: torch.Tensor, act_scale
) -> torch.Tensor:
    """The int8 head's f32 logits [B, V], as the kernel forms them: feats
    quantized, the int8 product summed exactly in f64 (|acc| ≤ D·127² ≪
    2⁵³; no device has an integer GEMM in plain PyTorch), then
    ``float(acc)·scale_v + b`` as two f32 operations."""
    acc = quantize_activations(feats, act_scale).double() @ w_q.double().t()
    return acc.float() * scale_v + b.float()


def head_predict_int8_reference(
    feats: torch.Tensor, w_q: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
    w_scale: torch.Tensor | None, act_scale, scale_v: torch.Tensor | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: :func:`int8_logits`, then CE and first-index
    argmax. (loss f32 [B], 0 where label < 0; pred int32 [B])."""
    if scale_v is None:
        scale_v = combined_scale(w_scale, act_scale)
    logits = int8_logits(feats, w_q, b, scale_v, act_scale)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    per = F.cross_entropy(logits, labels.clamp(min=0).long(), reduction="none")
    return torch.where(labels >= 0, per, torch.zeros_like(per)), preds


def head_predict_int8(
    feats: torch.Tensor, w_q: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
    w_scale: torch.Tensor | None, act_scale, scale_v: torch.Tensor | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-row CE f32 [B], argmax int32 [B]) of the int8 head
    ``softmax(dequant(q(feats) @ w_qᵀ) + b)``: feats float [B, D], w_q int8
    [V, D], b f32 [V], ``w_scale`` f32 [V] and ``act_scale``, or the
    precomputed ``scale_v`` (:func:`combined_scale`). The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. ``route`` forces the
    kernel's route (``fused_head_ce.tc_route``), to time one against the
    other."""
    check_shapes(feats, w_q, b, labels, "head_predict_int8")
    if scale_v is None:
        scale_v = combined_scale(w_scale, act_scale)
    if _build.on_cpu(feats, "head_predict_int8"):
        return head_predict_int8_reference(feats, w_q, b, labels, None, act_scale, scale_v)
    if feats.dtype not in _build.DTYPE_CODE or w_q.dtype != torch.int8:
        raise TypeError(
            f"head_predict_int8's kernel takes bf16 or f32 feats and int8 W, "
            f"got {feats.dtype} and {w_q.dtype}"
        )
    if b.dtype != torch.float32 or scale_v.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(
            f"head_predict_int8 needs f32 b and scale_v and int32 labels, got "
            f"{b.dtype}, {scale_v.dtype}, {labels.dtype}"
        )
    bsz, d = feats.shape
    vocab = w_q.shape[0]
    if d % 16:
        raise ValueError(f"head_predict_int8 kernel needs D % 16 == 0, got D={d}")
    if tuple(scale_v.shape) != (vocab,):
        raise ValueError(f"head_predict_int8 takes scale_v [V], got {tuple(scale_v.shape)}")
    act = _f32(act_scale)
    if not act > 0:
        raise ValueError(f"head_predict_int8 needs act_scale > 0, got {act}")
    dev = feats.device
    check_kernel_operands("head_predict_int8", dev, feats=feats, w_q=w_q, b=b, labels=labels,
                          scale_v=scale_v)
    n_split, tiles_per_split, route, rows = tc_geometry(bsz, d, vocab, 1, _num_sms(dev.index),
                                                        route)
    feats_q = torch.empty((bsz, d), dtype=torch.int8, device=dev)
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    pred = torch.empty((bsz,), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mpt_head_predict_int8(
            feats.data_ptr(), feats_q.data_ptr(), w_q.data_ptr(), scale_v.data_ptr(),
            b.data_ptr(), labels.data_ptr(), loss.data_ptr(), pred.data_ptr(),
            part_mlp.data_ptr(), part_arg.data_ptr(), bsz, d, vocab, n_split,
            tiles_per_split, ROUTE_CODE[route], rows, act, _build.DTYPE_CODE[feats.dtype],
            _build.stream(dev),
        )
    _build.check(code, "head_predict_int8")
    (counter_wide if route == "streamed" else counter).add()
    return loss, pred


# --------------------------------------------------------------------------
# the parity oracle
# --------------------------------------------------------------------------


def parity_probe(
    model: nn.Module, qmodel: nn.Module, compute_dtype: torch.dtype, images: np.ndarray, *,
    topk: int = 5, fused_head: bool = False,
) -> dict:
    """The same sample through the float and the int8 predict paths (the
    fused ones when ``fused_head``): ``{"samples", "top1_agree",
    "top5_agree"}`` — top-1 the share of rows whose classes agree, top-5
    (None below topk 5) the share whose float argmax is in the int8 top 5."""
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step

    dev = next(model.parameters()).device
    x = torch.from_numpy(images).to(dev)
    labels = torch.full((len(images),), -1, dtype=torch.int32, device=dev)
    predict_ref = make_predict_step(compute_dtype, fused_head=fused_head, topk=topk)
    predict_q = make_predict_step(compute_dtype, fused_head=fused_head, topk=topk,
                                  int8_head=fused_head)
    n = len(images)
    p_ref = predict_ref(model, x, labels)[1].cpu().numpy().reshape(n, -1)
    p_q = predict_q(qmodel, x, labels)[1].cpu().numpy().reshape(n, -1)
    top1 = float(np.mean(p_ref[:, 0] == p_q[:, 0]))
    top5 = None
    if p_ref.shape[1] >= 5 and p_q.shape[1] >= 5:
        top5 = float(np.mean([p_ref[i, 0] in p_q[i, :5] for i in range(n)]))
    return {"samples": n, "top1_agree": round(top1, 4),
            "top5_agree": None if top5 is None else round(top5, 4)}


@torch.no_grad()
def max_logit_drift(
    model: nn.Module, qmodel_plain: nn.Module, images: np.ndarray, compute_dtype: torch.dtype
) -> float:
    """max |float-path logit − int8-path logit| over the sample.
    ``qmodel_plain`` must dequantize its head too (no ``keep_head_int8``):
    the fused head gives no logits to compare."""
    dev = next(model.parameters()).device
    x = ingest_images(torch.from_numpy(images).to(dev), compute_dtype).permute(0, 3, 1, 2)
    return float((model(x).float() - qmodel_plain(x).float()).abs().max())
