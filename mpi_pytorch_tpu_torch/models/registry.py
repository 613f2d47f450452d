"""Model factory (``mpi_pytorch_tpu/models/registry.py``) for the ported
architectures: dispatch on a name, build with a ``num_classes`` head,
optionally with the fused stem, and place the module for serving or for
training."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.resnet import resnet18, resnet34

# name → (factory, canonical input size), as in the JAX registry.
_REGISTRY = {
    "resnet18": (resnet18, 224),
    "resnet34": (resnet34, 128),
}

# Architectures whose factories accept fused_stem (the bn1+relu+maxpool
# kernel, ops/fused_stem.py). The JAX set also has densenet121, which this
# port has not reached yet.
FUSED_STEM_MODELS = ("resnet18", "resnet34")


def initialize_model(
    model_name: str, num_classes: int, *, fused_stem: bool = False
) -> tuple[nn.Module, int]:
    """Reference-parity signature: returns (model, input_size). Parameters
    come from torch's default initializers; serving loads its weights
    afterwards (``models/convert.py`` or :func:`init_weights`)."""
    if model_name not in _REGISTRY:
        raise ValueError(
            f"unsupported model {model_name!r}; expected one of {tuple(_REGISTRY)}"
        )
    if fused_stem and model_name not in FUSED_STEM_MODELS:
        raise ValueError(
            f"fused_stem is only implemented for the 7×7-stem family "
            f"({', '.join(FUSED_STEM_MODELS)}); {model_name!r} has no such stem"
        )
    factory, input_size = _REGISTRY[model_name]
    return factory(num_classes, fused_stem=fused_stem), input_size


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What the training and eval drivers need to know about a model."""

    model: nn.Module
    input_size: int
    name: str
    # parameter name → trains; None = all train (``feature_extract`` keeps
    # only the head, as the JAX ``head_filter`` does).
    trainable_mask: dict[str, bool] | None


def head_filter(name: str) -> bool:
    """True for the parameters of the classification head (``fc``), the
    part that stays trainable under ``feature_extract``."""
    return name.split(".")[0] == "fc"


def create_model_bundle(
    model_name: str,
    num_classes: int,
    feature_extract: bool = False,
    *,
    seed: int = 0,
    image_size: int | None = None,
    fused_stem: bool = False,
) -> ModelBundle:
    """The model with seeded random weights (:func:`init_weights` from
    ``seed``), its input size (``image_size``, else 128, as the JAX factory
    does) and the trainable mask."""
    model, _ = initialize_model(model_name, num_classes, fused_stem=fused_stem)
    init_weights(model, torch.Generator().manual_seed(seed))
    mask = None
    if feature_extract:
        mask = {name: head_filter(name) for name, _ in model.named_parameters()}
    return ModelBundle(
        model=model, input_size=image_size or 128, name=model_name, trainable_mask=mask
    )


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, drawn on the CPU from ``generator``: He-normal
    convs (fan-out, as torchvision's resnet), a N(0, 0.01²) head with zero
    bias, and batchnorm with random positive running statistics — so a
    random model's stem and blocks do real normalization work."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_out) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=generator))
                m.bias.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(c, generator=generator))
            elif isinstance(m, nn.Linear):
                m.weight.copy_(0.01 * torch.randn(m.weight.shape, generator=generator))
                m.bias.zero_()


def prepare_for_inference(
    model: nn.Module, device: torch.device, compute_dtype: torch.dtype
) -> nn.Module:
    """Eval mode on ``device`` with gradients off: 4-D weights in
    channels_last memory, conv weights cast ONCE to the compute dtype;
    batchnorm and the head keep their f32 parameters (the plain head casts
    per call, as the JAX Dense does)."""
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    model.requires_grad_(False)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype=compute_dtype)
    return model


def prepare_for_training(model: nn.Module, device: torch.device) -> nn.Module:
    """Train mode on ``device``: 4-D weights in channels_last memory, every
    parameter an f32 master (convolutions and the head cast to the compute
    dtype per call), gradients on."""
    model = model.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)
    model.requires_grad_(True)
    return model.train()
