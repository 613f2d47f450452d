"""VGG-11 with batchnorm (``mpi_pytorch_tpu/models/vgg.py``): the VGG-A
stack of unbiased 3×3 convolutions, each with batchnorm and relu, 2×2
max pools, the adaptive 7×7 pool, and the 4096–4096–classes classifier
with dropout 0.5 after each of its first two dense layers.

State names follow the JAX module's (``conv{i}``, ``bn{i}``, ``fc1``,
``fc2``), the head is ``fc``. As alexnet's, the pooled map is flattened
CHW where flax flattens HWC (``models/convert.py`` permutes ``fc1``'s
rows). At 64 500 classes the model holds about 392 M parameters (1.6 GB
of f32 masters): place it once and never copy it.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    Dropout,
    adaptive_avg_pool,
    batch_norm,
    max_pool,
)

# 'M' = 2×2 max pool; numbers = a 3×3 convolution's output channels.
VGG11_CFG: Sequence[Any] = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
POOL_HW = 7


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Any], num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, i = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            self.add_module(f"conv{i}", Conv2d(cin, v, 3, padding=1, bias=False))
            self.add_module(f"bn{i}", batch_norm(v))
            cin, i = v, i + 1
        self.fc1 = Dense(cin * POOL_HW * POOL_HW, 4096)
        self.drop1 = Dropout(dropout_rate)
        self.fc2 = Dense(4096, 4096)
        self.drop2 = Dropout(dropout_rate)
        self.fc = Dense(4096, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x, 2, 2)
                continue
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            i += 1
        x = torch.flatten(adaptive_avg_pool(x, (POOL_HW, POOL_HW)), 1)
        x = self.drop1(torch.relu(self.fc1(x)))
        return self.drop2(torch.relu(self.fc2(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def vgg11_bn(num_classes: int, **kw) -> VGG:
    return VGG(VGG11_CFG, num_classes, **kw)
