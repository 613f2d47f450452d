"""Shared building blocks of the port's models (``mpi_pytorch_tpu/models/
common.py``): batchnorm, the fused stem module, convolutions, pools, dense
layers and layer norm.

Activations are NCHW tensors in channels_last memory end to end, so a
conv output viewed with ``permute(0, 2, 3, 1)`` is NHWC memory with no
copy — the layout the fused stem kernels read. Parameters are f32 masters:
each convolution and dense layer casts its weights to the input's
(compute) dtype per call, as flax's ``dtype=`` does, so a bf16 model rounds
where the JAX model rounds. Normalization parameters and running
statistics stay f32.

Under data parallelism a batchnorm can take its training statistics over
the global batch (:func:`set_batchnorm_sync`): each rank sums its rows' y
and y² per channel, and the sums and the row count are all-reduced with
autograd attached (``parallel.collectives.sum_over_ranks``, the semantics
of ``torch.distributed.nn.functional.all_reduce``), whose backward sums
every rank's gradient of the statistics — right when each rank's loss is
its own share of the global loss. Under a model axis the sums run over the
data axis only (the ranks of a model group hold the same rows).

The zoo's pieces (``mpi_pytorch_tpu/models/common.py`` and the model
files): flax's ``'SAME'`` convolution (:class:`SameConv2d`), its
``'VALID'`` max and count-padding average pools, the adaptive average
pool's window rule, ``relu6`` and SiLU, and the train-mode randomness —
:class:`Dropout` and :class:`StochasticDepth`, whose masks come from an
explicit per-rank ``torch.Generator`` (:func:`set_rng`). Depthwise
convolutions are ``Conv2d(..., groups=C)``, weight ``[C, 1, kh, kw]``.

The auto step's levers (``train/state.place_model``): the head ``fc`` of
every ported model becomes a :class:`VocabParallelDense` — a block of the
classes' rows on each rank of the model axis — and under FSDP a
parameter becomes its shard at rest, gathered at each use through the
parametrization :class:`GatheredShard` (the fused stem's autograd
Function and the batchnorms then see whole tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.ops.fused_stem import stem_affine_relu_pool
from mpi_pytorch_tpu_torch.parallel import collectives
from mpi_pytorch_tpu_torch.parallel.mesh import Axis

# torch BatchNorm defaults (the JAX package's BN_EPS / BN_MOMENTUM = 1 − 0.1).
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _channel_stats(x: torch.Tensor, sync: bool = False,
                   axis: Axis | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 batch mean and ``E[x²] − mean²`` per channel of an NCHW tensor,
    with autograd attached (the gradient through the statistics reaches
    ``x``, as it does in JAX). With ``sync`` over an axis of more than one
    rank (``axis``; the world by default), over the global batch: the
    per-channel sums of x and x² and the row count, all-reduced (SUM) in
    one autograd-aware collective. (f32 for bf16 and f32 inputs; a float64
    input keeps float64, as flax promotes the statistics' dtype to at
    least f32.)"""
    xf = x.to(_stats_dtype(x))
    size = collectives.num_processes() if axis is None else axis.size
    if sync and size > 1:
        c = xf.shape[1]
        sums = torch.cat([
            xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
            xf.new_full((1,), xf.numel() // c),
        ])
        sums = collectives.sum_over_ranks(sums, axis)
        mean = sums[:c] / sums[-1]
        return mean, sums[c:2 * c] / sums[-1] - mean.square()
    mean = xf.mean(dim=(0, 2, 3))
    return mean, xf.square().mean(dim=(0, 2, 3)) - mean.square()


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with torch's defaults and state names (``weight``,
    ``bias``, ``running_mean``, ``running_var``) and flax's training
    arithmetic.

    Eval mode normalizes with the running statistics (``nn.BatchNorm2d``;
    f32 parameters work on a bf16 input). Training mode follows flax
    ``BatchNorm`` (``_compute_stats``/``_normalize``): the batch mean and
    fast variance ``E[x²] − mean²`` in f32, clipped at 0; the output
    ``(x − mean)·(rsqrt(var+ε)·γ) + β`` in f32, cast to the input's dtype;
    and the running statistics updated with momentum 0.1 and the BIASED
    batch variance (``nn.BatchNorm2d`` would use the unbiased one).
    ``num_batches_tracked`` stays as torch made it: the momentum is fixed.

    ``sync_stats`` (:func:`set_batchnorm_sync`) takes the training
    statistics over every rank's rows of ``sync_axis`` (the world when
    None; flax ``BatchNorm(axis_name=...)``, and the JAX auto mode's
    global batch)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)
        self.sync_stats = False
        self.sync_axis: Axis | None = None

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``ra = (1 − m)·ra + m·stat`` with the batch mean and biased
        variance (flax's ``momentum·ra + (1 − momentum)·stat``)."""
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean, var = _channel_stats(x, self.sync_stats, self.sync_axis)
        var = var.clamp_min(0.0)
        self.update_running_stats(mean, var)
        dt = _stats_dtype(x)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        y = (x.to(dt) - _per_channel(mean)) * _per_channel(mul) + _per_channel(self.bias.to(dt))
        return y.to(x.dtype)


def batch_norm(num_features: int, eps: float = BN_EPS) -> BatchNorm:
    """The port's batchnorm (see :class:`BatchNorm`)."""
    return BatchNorm(num_features, eps=eps)


def set_batchnorm_sync(model: nn.Module, sync: bool, axis: Axis | None = None) -> None:
    """Every batchnorm of ``model`` (the fused stem's too) takes its
    training statistics over the global batch (``sync``: the rows of every
    rank of ``axis``, the data axis; the world when None) or over this
    rank's rows. One rank's statistics are the same either way."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_stats, m.sync_axis = sync, axis


class FusedStemBNReluPool(BatchNorm):
    """BatchNorm + ReLU + 3×3/s2/p1 max-pool as ONE op — the resnet stem
    tail (torchvision ``bn1``/``relu``/``maxpool``) through the fused stem
    kernels (``ops/fused_stem.py``).

    Same parameters and buffers as ``batch_norm``, so state dicts move
    freely between the fused and unfused stem. It folds
    ``a = γ·rsqrt(var+ε)``, ``b = β − μ·a`` in f32 — from the running
    statistics in eval mode, from the batch in training mode — hands the
    conv output to the kernels as NHWC and returns channels_last NCHW in
    the input's dtype.

    Training mirrors the JAX module: f32 batch mean and ``E[y²] − mean²``,
    NOT clipped (the fused module does not clip), the biased running
    update, and ``a``/``b`` folded with autograd attached, so the gradient
    through the statistics reaches ``y`` beside the kernel's own ``dy``.
    With ``sync_stats`` the statistics are the global batch's, so the
    kernels get ``a``/``b`` folded from them and the local ``da``/``db``
    the backward kernel returns flow back through the all-reduce."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = _channel_stats(y, self.sync_stats, self.sync_axis)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        a = self.weight.float() * torch.rsqrt(var + self.eps)
        b = self.bias.float() - mean * a
        out = stem_affine_relu_pool(y.permute(0, 2, 3, 1), a, b)
        return out.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """A convolution whose f32 master weight is cast to the input's dtype
    per call (a no-op once ``prepare_for_inference`` has cast it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class SameConv2d(Conv2d):
    """flax ``Conv``'s default ``'SAME'`` padding: ``ceil(n / stride)``
    outputs a spatial dim, the padding ``max((out − 1)·stride + k − n, 0)``
    split ``total // 2`` before and the rest after — uneven for an odd
    total, which no ``nn.Conv2d`` padding expresses (squeezenet's 7×7/s2
    stem pads 2 before and 3 after at even sizes)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_padding(x, self.kernel_size, self.stride))


def same_padding(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int]) -> torch.Tensor:
    """``x`` zero-padded as flax's ``'SAME'`` pads it for ``kernel`` and
    ``stride`` (see :class:`SameConv2d`)."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool with −inf padding (torch's, and flax's reduce_window).
    Without padding it is flax's ``'VALID'``: the output size rounds down
    (torch's ``ceil_mode=False``), where torchvision's squeezenet rounds
    up."""
    return F.max_pool2d(x, kernel_size=window, stride=stride, padding=padding)


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """flax ``nn.avg_pool``: the window's sum over the window's size, the
    zero padding counted (flax's ``count_include_pad=True`` default, as
    inception's 3×3/s1/p1 branch pools have it); no padding is
    ``'VALID'``."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The JAX package's ``adaptive_avg_pool`` (torch's
    ``AdaptiveAvgPool2d`` rule): output cell (i, j) averages rows
    ``[floor(i·H/th), ceil((i+1)·H/th))`` and the same over the columns.
    Equal windows are one pool; any other shape — also an upsampling, as
    alexnet's 3×3 map at 128 px going to 6×6 — averages the rows' slices,
    then the columns', as the JAX function does."""
    th, tw = out_hw
    h, w = x.shape[2], x.shape[3]
    if (h, w) == (th, tw):
        return x
    if h % th == 0 and w % tw == 0:
        return F.avg_pool2d(x, (h // th, w // tw))
    x = torch.cat([x[:, :, (i * h) // th: -(-((i + 1) * h) // th)].mean(dim=2, keepdim=True)
                   for i in range(th)], dim=2)
    return torch.cat([x[:, :, :, (j * w) // tw: -(-((j + 1) * w) // tw)].mean(dim=3, keepdim=True)
                      for j in range(tw)], dim=3)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, C] mean over the spatial dims."""
    return x.mean(dim=(2, 3))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(relu(x), 6)`` (the JAX mobilenet's ``relu6``)."""
    return torch.clamp(x, 0.0, 6.0)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x·sigmoid(x)`` (flax ``nn.silu``)."""
    return x * torch.sigmoid(x)


def _keep_mask(shape, like: torch.Tensor, keep: float, generator: torch.Generator | None,
               what: str) -> torch.Tensor:
    """A boolean mask of ``shape``, each entry True with probability
    ``keep``, drawn from ``generator`` on ``like``'s device in its memory
    format."""
    if generator is None:
        raise RuntimeError(
            f"{what} in train mode draws its masks from an explicit generator: "
            "set one with models.common.set_rng(model, generator)"
        )
    if tuple(shape) == tuple(like.shape):
        u = torch.empty_like(like, dtype=torch.float32)
    else:
        u = torch.empty(shape, dtype=torch.float32, device=like.device)
    return u.uniform_(0.0, 1.0, generator=generator) < keep


def _scaled_select(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """``where(mask, x / keep, 0)`` in ``x``'s dtype, the division correct
    to the last bit (a tensor divisor: CUDA turns a division by a Python
    scalar into a multiply by its reciprocal)."""
    scaled = torch.div(x, torch.full((), keep, dtype=x.dtype, device=x.device))
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each entry is kept with
    probability ``1 − p`` and scaled by ``1/(1 − p)``, else zeroed; the
    identity in eval mode or at ``p = 0``. The masks come from
    ``self.generator``, a ``torch.Generator`` on the activations' device
    that the train step sets (:func:`set_rng`): one stream a data shard,
    as the JAX step draws one a shard."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return _scaled_select(x, _keep_mask(x.shape, x, keep, self.generator, "Dropout"), keep)


class StochasticDepth(nn.Module):
    """Per-sample stochastic depth (the JAX efficientnet's residual
    branch, "row" mode): in train mode a whole sample's branch is kept
    with probability ``1 − p`` — one [B, 1, 1, 1] mask — and scaled by
    ``1/(1 − p)``; the identity in eval mode or at ``p = 0``. Masks from
    ``self.generator`` as :class:`Dropout`'s."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = _keep_mask((x.shape[0], 1, 1, 1), x, keep, self.generator, "StochasticDepth")
        return _scaled_select(x, mask, keep)


def set_rng(model: nn.Module, generator: torch.Generator | None) -> None:
    """Every :class:`Dropout` and :class:`StochasticDepth` of ``model``
    draws its train-mode masks from ``generator`` (the data shard's stream)."""
    for m in model.modules():
        if isinstance(m, (Dropout, StochasticDepth)):
            m.generator = generator


def has_randomness(model: nn.Module) -> bool:
    """Whether ``model``'s train-mode forward draws any mask."""
    return any(isinstance(m, (Dropout, StochasticDepth)) and m.p > 0 for m in model.modules())


class Dense(nn.Linear):
    """flax ``Dense``: weight ``[out, in]`` (K-major) and bias as f32
    masters, the matmul in the input's (compute) dtype — both cast per call
    (a no-op once ``prepare_for_inference`` has cast them). As the head, the
    predict step recasts its logits to f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class VocabParallelDense(Dense):
    """The head over a model axis (JAX's head kernel sharded on its class
    dimension over ``model``): this rank's rows ``start … start + V/mp``
    of the ``[V, D]`` weight and of the bias, ``start = index·V/mp``. The
    forward reads the features through ``collectives.copy_to_model`` (the
    backward sums ``dfeats`` over the axis) and returns this rank's block
    of the logits, [B, V/mp]; the loss and the argmax over the blocks are
    ``ops.losses.vocab_parallel_ce_sum`` and ``vocab_parallel_argmax``.
    The state names stay ``weight`` and ``bias``."""

    def __init__(self, in_features: int, num_classes: int, axis: Axis):
        if num_classes % axis.size:
            raise ValueError(f"{num_classes} classes not divisible by the model axis's "
                             f"{axis.size} ranks")
        rows = num_classes // axis.size
        super().__init__(in_features, rows)
        self.num_classes, self.axis, self.vocab_start = num_classes, axis, axis.index * rows

    @classmethod
    def from_dense(cls, dense: nn.Linear, axis: Axis) -> "VocabParallelDense":
        """This rank's block of ``dense`` (on its device, in its dtype)."""
        w = dense.weight.detach()
        head = cls(w.shape[1], w.shape[0], axis).to(device=w.device, dtype=w.dtype)
        rows = slice(head.vocab_start, head.vocab_start + head.out_features)
        with torch.no_grad():
            head.weight.copy_(w[rows])
            head.bias.copy_(dense.bias.detach()[rows])
        head.weight.requires_grad_(dense.weight.requires_grad)
        head.bias.requires_grad_(dense.bias.requires_grad)
        return head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(collectives.copy_to_model(x, self.axis))


class GatheredShard(nn.Module):
    """The FSDP parametrization of one parameter
    (``torch.nn.utils.parametrize``): the module holds this rank's block
    along ``dim`` over ``axis`` (the data axis) at rest — the parameter
    the optimizer steps — and each read of the parameter is the whole
    tensor, gathered with autograd attached
    (``collectives.gather_shards``: the backward reduce-scatters the
    gradient into the shard's). The gathered tensor lives only as long as
    the graph that read it."""

    def __init__(self, axis: Axis, dim: int):
        super().__init__()
        self.axis, self.dim = axis, dim

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return collectives.gather_shards(shard, self.axis, self.dim)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        """The whole tensor's block of this rank (what the module keeps)."""
        k = whole.shape[self.dim] // self.axis.size
        return whole.detach().narrow(self.dim, self.axis.index * k, k).clone()


# flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with torch's state names (``weight``,
    ``bias``, f32) and flax ``LayerNorm``'s arithmetic: ε = 1e-6, the f32
    mean and fast variance ``E[x²] − mean²`` clipped at 0, then
    ``(x − mean)·(rsqrt(var + ε)·γ) + β`` in f32, cast to the input's
    dtype."""

    def __init__(self, num_features: int, eps: float = LN_EPS):
        super().__init__(num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)
