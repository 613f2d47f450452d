"""Vision Transformer (``mpi_pytorch_tpu/models/vit.py``): ViT-S/16 and
ViT-B/16 with dense MLPs, single-device attention.

Patch-embed conv (with bias) → learned position embeddings [1, S, hidden]
(no class token) → pre-LN encoder blocks, ``x + MHA(LN(x))`` then
``x + MLP(LN(x))`` with tanh-GELU (``jax.nn.gelu``'s default) → final LN →
global average pool over tokens → the ``fc`` head. Layer norms are flax's
(``common.LayerNorm``, ε = 1e-6) and every dense layer casts its f32 master
weights to the compute dtype per call.

Attention dispatches on ``attn_impl`` as the JAX module does: ``full``
(``ops/ring_attention.py``), ``flash`` (``ops/flash_attention.py``) or
``fused-small`` (``ops/fused_attention_small.py``) — one function, three
executions. q, k and v leave their projections as [B, S, H·Dh] and reach
the kernels as strided [B, S, H, Dh] views, with no transpose.
``qkv_fused`` computes the three projections as one matmul over their
concatenated weights, with the same state names, so checkpoints move
freely between the two layouts.

``features`` is the forward up to the pooled [B, hidden] features and
``fc`` the head: what the fused predict step (``evaluate.py``) reads, as
for the resnets. Dropout (0 in the JAX models), sequence parallelism, MoE
MLPs and per-block remat are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.models.common import Conv2d, Dense, LayerNorm
from mpi_pytorch_tpu_torch.ops.flash_attention import flash_attention
from mpi_pytorch_tpu_torch.ops.fused_attention_small import fused_attention_small
from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

ATTENTION = {
    "full": full_attention,
    "flash": flash_attention,
    "fused-small": fused_attention_small,
}


class MultiHeadAttention(nn.Module):
    """q, k, v and out projections (``q``/``k``/``v``: hidden → H·Dh, the
    flax DenseGeneral kernels [hidden, H, Dh] flattened; ``out``: H·Dh →
    hidden) around the ``attn_impl`` attention."""

    def __init__(self, hidden: int, num_heads: int, attn_impl: str = "full",
                 qkv_fused: bool = False):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by {num_heads} heads")
        if attn_impl not in ATTENTION:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.num_heads, self.attn_impl, self.qkv_fused = num_heads, attn_impl, qkv_fused
        self.q, self.k, self.v = (Dense(hidden, hidden) for _ in range(3))
        self.out = Dense(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qkv_fused:
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight]).to(x.dtype)
            b = torch.cat([self.q.bias, self.k.bias, self.v.bias]).to(x.dtype)
            q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        heads = (self.num_heads, x.shape[-1] // self.num_heads)
        out = ATTENTION[self.attn_impl](*(t.unflatten(-1, heads) for t in (q, k, v)))
        return self.out(out.flatten(2))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + MHA(ln1(x))``, then ``x + mlp2(gelu(mlp1(ln2(x))))``."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, attn_impl: str = "full",
                 qkv_fused: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(hidden)
        self.attn = MultiHeadAttention(hidden, num_heads, attn_impl, qkv_fused)
        self.ln2 = LayerNorm(hidden)
        self.mlp1 = Dense(hidden, mlp_dim)
        self.mlp2 = Dense(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate="tanh"))


class VisionTransformer(nn.Module):
    """ViT over ``image_size`` (an int, or (H, W)) inputs: the token grid
    and so ``pos_embed`` [1, (H/p)·(W/p), hidden] are fixed at
    construction, as the JAX model fixes them at init."""

    def __init__(self, num_classes: int, image_size: int | tuple[int, int] = 224, *,
                 patch_size: int = 16, hidden: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_dim: int = 1536, attn_impl: str = "full",
                 qkv_fused: bool = False):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
        if h % patch_size or w % patch_size:
            raise ValueError(f"image {h}x{w} not divisible by patch {patch_size}")
        self.num_heads = num_heads
        self.patch_embed = Conv2d(3, hidden, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, (h // patch_size) * (w // patch_size), hidden))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, num_heads, mlp_dim, attn_impl, qkv_fused) for _ in range(depth)
        )
        self.ln = LayerNorm(hidden)
        self.fc = Dense(hidden, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW input in the compute dtype → pooled [B, hidden] features,
        the head's input. Tokens run row-major over the patch grid."""
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, S, hidden]
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln(x).mean(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn on the CPU from ``generator``:
        lecun-normal kernels (truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796,
        fan_in over the flattened 2-D kernel — the patch embed's p·p·3, a
        projection's input width) with zero biases, ``pos_embed``
        N(0, 0.02²), layer norms ones and zeros."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                std = fan_in**-0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)


def vit_s16(num_classes: int, **kw) -> VisionTransformer:
    """ViT-Small/16: 384 hidden, 12 blocks, 6 heads, MLP 1536."""
    return VisionTransformer(num_classes, **kw)


def vit_b16(num_classes: int, **kw) -> VisionTransformer:
    """ViT-Base/16: 768 hidden, 12 blocks, 12 heads, MLP 3072."""
    return VisionTransformer(num_classes, hidden=768, num_heads=12, mlp_dim=3072, **kw)
