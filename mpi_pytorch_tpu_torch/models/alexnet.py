"""AlexNet (``mpi_pytorch_tpu/models/alexnet.py``): five biased
convolutions with max pools, the adaptive 6×6 pool, and the
4096–4096–classes classifier with dropout 0.5 before each of its first
two dense layers.

State names follow the JAX module's (``conv1`` … ``conv5``, ``fc1``,
``fc2``), the head is ``fc`` (flax ``head``). The pooled map is flattened
in torch's CHW order; flax flattens HWC, so ``fc1``'s input rows are a
permutation of the flax kernel's (``models/convert.py`` applies it).
``features`` is the forward up to the head's input, [B, 4096].
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    Dropout,
    adaptive_avg_pool,
    max_pool,
)

POOL_HW = 6  # the adaptive pool's output side


class AlexNet(nn.Module):
    def __init__(self, num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = Conv2d(64, 192, 5, padding=2)
        self.conv3 = Conv2d(192, 384, 3, padding=1)
        self.conv4 = Conv2d(384, 256, 3, padding=1)
        self.conv5 = Conv2d(256, 256, 3, padding=1)
        self.drop1 = Dropout(dropout_rate)
        self.fc1 = Dense(256 * POOL_HW * POOL_HW, 4096)
        self.drop2 = Dropout(dropout_rate)
        self.fc2 = Dense(4096, 4096)
        self.fc = Dense(4096, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x)), 3, 2)
        x = max_pool(torch.relu(self.conv2(x)), 3, 2)
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.conv4(x))
        x = max_pool(torch.relu(self.conv5(x)), 3, 2)
        x = torch.flatten(adaptive_avg_pool(x, (POOL_HW, POOL_HW)), 1)
        x = torch.relu(self.fc1(self.drop1(x)))
        return torch.relu(self.fc2(self.drop2(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def alexnet(num_classes: int, **kw) -> AlexNet:
    return AlexNet(num_classes, **kw)
