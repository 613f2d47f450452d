"""ResNet-18/34 (``mpi_pytorch_tpu/models/resnet.py``), with torchvision's
state names: ``conv1``, ``bn1``, ``layer{1..4}.{i}.conv1/bn1/conv2/bn2``,
``layer{s}.0.downsample.0/1`` and the head ``fc``.

Padding follows the JAX model: the 7×7/s2 stem conv pads 3, every 3×3
conv pads 1, and the 1×1/s2 downsample conv is flax ``'SAME'``, which for
the even sizes it meets is no padding at all. ``features`` is the forward
up to the global pool — the input of the head, which the fused predict
step hands to the streaming head kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Classifier,
    FusedStemBNReluPool,
    batch_norm,
    global_avg_pool,
    max_pool,
)


def _conv(cin: int, cout: int, k: int, stride: int, pad: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1)
        self.bn1 = batch_norm(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = batch_norm(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride, 0), batch_norm(features)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int, fused_stem: bool = False):
        super().__init__()
        self.fused_stem = fused_stem
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FusedStemBNReluPool(64) if fused_stem else batch_norm(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2**stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(cin, features, stride))
                cin = features
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = Classifier(cin, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW (channels_last) input in the compute dtype → pooled
        [B, 512] features, the head's input."""
        x = self.conv1(x)
        if self.fused_stem:
            x = self.bn1(x)
        else:
            x = max_pool(torch.relu(self.bn1(x)), 3, 2, padding=1)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return global_avg_pool(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def resnet18(num_classes: int, **kw) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, **kw)


def resnet34(num_classes: int, **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, **kw)
