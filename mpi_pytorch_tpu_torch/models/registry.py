"""Model factory (``mpi_pytorch_tpu/models/registry.py``) for the ported
architectures — the nine CNNs of the JAX zoo and the two dense vits:
dispatch on a name, build with a ``num_classes`` head, optionally with the
fused stem (resnets, densenet121) or an attention kernel (vits), and place
the module for serving or for training.

Heads: every model but squeezenet1_0 ends in a dense head ``fc`` (the
streaming and int8 predict heads take it); squeezenet1_0's head is the
1×1 convolution ``head``; inception_v3 also has the auxiliary dense head
``AuxLogits.fc``, run in train mode only. :func:`head_filter` names them
all, as the JAX ``head_filter`` names ``head`` and ``aux_head``."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.alexnet import alexnet
from mpi_pytorch_tpu_torch.models.common import Dense
from mpi_pytorch_tpu_torch.models.densenet import densenet121
from mpi_pytorch_tpu_torch.models.efficientnet import efficientnet_b0
from mpi_pytorch_tpu_torch.models.inception import inception_v3
from mpi_pytorch_tpu_torch.models.mobilenet import mobilenet_v2
from mpi_pytorch_tpu_torch.models.resnet import resnet18, resnet34
from mpi_pytorch_tpu_torch.models.squeezenet import squeezenet1_0
from mpi_pytorch_tpu_torch.models.vgg import vgg11_bn
from mpi_pytorch_tpu_torch.models.vit import vit_b16, vit_s16
from mpi_pytorch_tpu_torch.parallel.mesh import HEAD_NAMES

# name → (factory, canonical input size), as in the JAX registry.
_REGISTRY = {
    "resnet18": (resnet18, 224),
    "resnet34": (resnet34, 128),
    "alexnet": (alexnet, 224),
    "vgg11_bn": (vgg11_bn, 224),
    "squeezenet1_0": (squeezenet1_0, 224),
    "densenet121": (densenet121, 224),
    "inception_v3": (inception_v3, 299),
    "mobilenet_v2": (mobilenet_v2, 224),
    "efficientnet_b0": (efficientnet_b0, 224),
    "vit_s16": (vit_s16, 224),
    "vit_b16": (vit_b16, 224),
}

# The model whose train-mode forward returns (logits, aux logits).
AUX_LOGITS_MODELS = ("inception_v3",)

# Architectures with attention, which take attn_impl and qkv_fused (the JAX
# SP_MODELS, less vit_moe_s16, whose MoE MLPs are not ported yet).
ATTENTION_MODELS = ("vit_s16", "vit_b16")

# Architectures whose factories accept fused_stem (the bn+relu+maxpool
# kernels, ops/fused_stem.py): the 7×7/s2/p3, 64-channel stem family.
FUSED_STEM_MODELS = ("resnet18", "resnet34", "densenet121")


def initialize_model(
    model_name: str,
    num_classes: int,
    *,
    fused_stem: bool = False,
    attn_impl: str = "full",
    qkv_fused: bool = False,
    image_size: int | tuple[int, int] | None = None,
) -> tuple[nn.Module, int]:
    """Reference-parity signature: returns (model, input_size). Parameters
    come from torch's default initializers; serving loads its weights
    afterwards (``models/convert.py`` or :func:`init_weights`). A vit fixes
    its token grid from ``image_size`` (default: the canonical size)."""
    if model_name not in _REGISTRY:
        raise ValueError(
            f"unsupported model {model_name!r}; expected one of {tuple(_REGISTRY)}"
        )
    if fused_stem and model_name not in FUSED_STEM_MODELS:
        raise ValueError(
            f"fused_stem is only implemented for the 7×7-stem family "
            f"({', '.join(FUSED_STEM_MODELS)}); {model_name!r} has no such stem"
        )
    if attn_impl != "full" and model_name not in ATTENTION_MODELS:
        raise ValueError(
            f"attn_impl={attn_impl!r} applies only to the attention family "
            f"({', '.join(ATTENTION_MODELS)}); {model_name!r} has no attention"
        )
    if qkv_fused and model_name not in ATTENTION_MODELS:
        raise ValueError(
            f"qkv_fused applies only to the attention family "
            f"({', '.join(ATTENTION_MODELS)}); {model_name!r} has no attention"
        )
    factory, input_size = _REGISTRY[model_name]
    if model_name in ATTENTION_MODELS:
        model = factory(num_classes, image_size=image_size or input_size,
                        attn_impl=attn_impl, qkv_fused=qkv_fused)
    elif model_name in FUSED_STEM_MODELS:
        model = factory(num_classes, fused_stem=fused_stem)
    else:
        model = factory(num_classes)
    return model, input_size


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What the training and eval drivers need to know about a model."""

    model: nn.Module
    input_size: int
    name: str
    # parameter name → trains; None = all train (``feature_extract`` keeps
    # only the heads, as the JAX ``head_filter`` does).
    trainable_mask: dict[str, bool] | None
    # The train-mode forward returns (logits, aux logits) (inception_v3).
    has_aux_logits: bool = False


def head_filter(name: str) -> bool:
    """True for the parameters of a classification head — a module named
    in ``HEAD_NAMES`` anywhere on the path (``fc.weight``,
    ``AuxLogits.fc.bias``, squeezenet's ``head.weight``), as the JAX
    ``head_filter`` matches ``head`` and ``aux_head`` — the part that stays
    trainable under ``feature_extract``."""
    return any(part in HEAD_NAMES for part in name.split(".")[:-1])


def create_model_bundle(
    model_name: str,
    num_classes: int,
    feature_extract: bool = False,
    *,
    seed: int = 0,
    image_size: int | tuple[int, int] | None = None,
    fused_stem: bool = False,
    attn_impl: str = "full",
    qkv_fused: bool = False,
) -> ModelBundle:
    """The model with seeded random weights (:func:`init_weights` from
    ``seed``), its input size (``image_size`` — an int or (H, W) — else
    128, or 299 for inception_v3, as the JAX factory does) and the
    trainable mask."""
    size = image_size or (299 if model_name == "inception_v3" else 128)
    model, _ = initialize_model(
        model_name, num_classes, fused_stem=fused_stem, attn_impl=attn_impl,
        qkv_fused=qkv_fused, image_size=size,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    mask = None
    if feature_extract:
        mask = {name: head_filter(name) for name, _ in model.named_parameters()}
    return ModelBundle(
        model=model, input_size=size if isinstance(size, int) else size[0],
        name=model_name, trainable_mask=mask,
        has_aux_logits=model_name in AUX_LOGITS_MODELS,
    )


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, drawn on the CPU from ``generator``. A model
    with its own ``init_weights`` (the vits: flax's initializers) uses it;
    a CNN gets He-normal convs (fan-out, as torchvision's resnet; a
    depthwise or grouped conv's fan-out is a group's, its output channels
    over the groups, times the window) with zero biases, N(0, 0.01²) dense
    layers with zero bias, and batchnorm with random positive running
    statistics — so a random model's stem and blocks do real normalization
    work."""
    if hasattr(model, "init_weights"):
        model.init_weights(generator)
        return
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_out) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
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
    channels_last memory, conv and dense weights (the head's aside) cast
    ONCE to the compute dtype; batchnorm, layer norms, position embeddings
    and the head keep their f32 parameters (the plain head casts per call,
    as the JAX Dense does, and the fused head cuts its own copy)."""
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    model.requires_grad_(False)
    head = getattr(model, "fc", None)
    for m in model.modules():
        if isinstance(m, nn.Conv2d) or (isinstance(m, Dense) and m is not head):
            m.to(dtype=compute_dtype)
    return model


def prepare_for_training(model: nn.Module, device: torch.device) -> nn.Module:
    """Train mode on ``device``: 4-D weights in channels_last memory, every
    parameter an f32 master (convolutions and dense layers cast to the
    compute dtype per call; batchnorm and layer norms compute in f32),
    gradients on."""
    model = model.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)
    model.requires_grad_(True)
    return model.train()
