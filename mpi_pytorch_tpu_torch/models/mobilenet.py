"""MobileNetV2 (``mpi_pytorch_tpu/models/mobilenet.py``): a 3×3/s2 stem,
inverted residuals (1×1 expand, depthwise 3×3, linear 1×1 project, the
residual where the stride is 1 and the channels match), relu6, the
1280-wide 1×1 head conv, the global pool, dropout 0.2 and the head
``fc``.

State names follow the JAX module's: ``stem``, ``stem_bn``,
``block{n}.{expand,expand_bn,depthwise,depthwise_bn,project,project_bn}``,
``head_conv``, ``head_bn``. Depthwise kernels are ``[C, 1, 3, 3]`` (flax
``[3, 3, 1, C]``).
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    Dropout,
    batch_norm,
    global_avg_pool,
    relu6,
)

# (expansion t, out channels c, repeats n, first stride s)
SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        self.expand_ratio = expand
        if expand != 1:
            self.expand = Conv2d(cin, hidden, 1, bias=False)
            self.expand_bn = batch_norm(hidden)
        self.depthwise = Conv2d(hidden, hidden, 3, stride=stride, padding=1, groups=hidden,
                                bias=False)
        self.depthwise_bn = batch_norm(hidden)
        self.project = Conv2d(hidden, features, 1, bias=False)
        self.project_bn = batch_norm(features)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_ratio != 1:
            y = relu6(self.expand_bn(self.expand(y)))
        y = relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int, dropout: float = 0.2):
        super().__init__()
        self.stem = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.stem_bn = batch_norm(32)
        cin, block = 32, 0
        for t, c, n, s in SETTINGS:
            for i in range(n):
                self.add_module(f"block{block}", InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin, block = c, block + 1
        self.n_blocks = block
        self.head_conv = Conv2d(cin, 1280, 1, bias=False)
        self.head_bn = batch_norm(1280)
        self.dropout = Dropout(dropout)
        self.fc = Dense(1280, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = relu6(self.stem_bn(self.stem(x)))
        for b in range(self.n_blocks):
            x = getattr(self, f"block{b}")(x)
        x = relu6(self.head_bn(self.head_conv(x)))
        return self.dropout(global_avg_pool(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def mobilenet_v2(num_classes: int, **kw) -> MobileNetV2:
    return MobileNetV2(num_classes, **kw)
