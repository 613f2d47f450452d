"""SqueezeNet 1.0 (``mpi_pytorch_tpu/models/squeezenet.py``): a 7×7/s2
stem with flax's ``'SAME'`` padding, Fire modules (a 1×1 squeeze, then
1×1 and 3×3 expands concatenated), max pools with flax's ``'VALID'``
floor, dropout 0.5, and a 1×1 convolution ``head`` over the classes
followed by relu and the global average pool.

The head is a convolution, not a dense layer: the model has no ``fc``,
so the fused predict head (``--fused-head-eval``) falls back to the plain
predict step and the int8 set quantizes the head as a convolution.
``features`` is the forward up to the head's input, the [B, 512, h, w]
map after dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dropout,
    SameConv2d,
    global_avg_pool,
    max_pool,
)


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.squeeze = Conv2d(cin, squeeze, 1)
        self.expand1x1 = Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)), torch.relu(self.expand3x3(s))], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, num_classes: int, dropout_rate: float = 0.5):
        super().__init__()
        self.conv1 = SameConv2d(3, 96, 7, stride=2)
        self.fire2 = Fire(96, 16, 64, 64)
        self.fire3 = Fire(128, 16, 64, 64)
        self.fire4 = Fire(128, 32, 128, 128)
        self.fire5 = Fire(256, 32, 128, 128)
        self.fire6 = Fire(256, 48, 192, 192)
        self.fire7 = Fire(384, 48, 192, 192)
        self.fire8 = Fire(384, 64, 256, 256)
        self.fire9 = Fire(512, 64, 256, 256)
        self.dropout = Dropout(dropout_rate)
        self.head = Conv2d(512, num_classes, 1)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(torch.relu(self.conv1(x)), 3, 2)
        x = self.fire4(self.fire3(self.fire2(x)))
        x = max_pool(x, 3, 2)
        x = self.fire8(self.fire7(self.fire6(self.fire5(x))))
        x = max_pool(x, 3, 2)
        return self.dropout(self.fire9(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(torch.relu(self.head(self.features(x))))


def squeezenet1_0(num_classes: int, **kw) -> SqueezeNet:
    return SqueezeNet(num_classes, **kw)
