"""EfficientNet-B0 (``mpi_pytorch_tpu/models/efficientnet.py``): a 3×3/s2
stem, MBConv blocks (1×1 expand, depthwise 3×3 or 5×5, squeeze-excite,
linear 1×1 project, the residual with per-sample stochastic depth where
the stride is 1 and the channels match), SiLU, batchnorm ε = 1e-3, the
1280-wide 1×1 head conv, the global pool, dropout 0.2 and the head ``fc``.

The squeeze-excite width is the block's INPUT channels ÷ 4, not the
expanded width. Block b's stochastic-depth rate is ``drop_path_rate·b/16``
(0 for the first), a [B, 1, 1, 1] mask from the rank's generator.

State names follow the JAX module's: ``stem``, ``stem_bn``,
``block{n}.{expand,expand_bn,depthwise,depthwise_bn,se.reduce,se.expand,
project,project_bn}``, ``head_conv``, ``head_bn``.
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    Dropout,
    StochasticDepth,
    batch_norm,
    global_avg_pool,
    silu,
)

BN_EPS = 1e-3
DROP_PATH_RATE = 0.2
# (expansion t, out channels c, repeats n, first stride s, kernel k)
SETTINGS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class SqueezeExcite(nn.Module):
    """Global pool → 1×1 ``reduce`` → SiLU → 1×1 ``expand`` → sigmoid gate
    on the input (both convolutions biased)."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.reduce = Conv2d(channels, squeeze, 1)
        self.expand = Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.expand(silu(self.reduce(s))))


class MBConv(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, expand: int, kernel: int,
                 drop_rate: float):
        super().__init__()
        hidden = cin * expand
        self.expand_ratio = expand
        if expand != 1:
            self.expand = Conv2d(cin, hidden, 1, bias=False)
            self.expand_bn = batch_norm(hidden, eps=BN_EPS)
        self.depthwise = Conv2d(hidden, hidden, kernel, stride=stride, padding=kernel // 2,
                                groups=hidden, bias=False)
        self.depthwise_bn = batch_norm(hidden, eps=BN_EPS)
        self.se = SqueezeExcite(hidden, max(1, cin // 4))
        self.project = Conv2d(hidden, features, 1, bias=False)
        self.project_bn = batch_norm(features, eps=BN_EPS)
        self.residual = stride == 1 and cin == features
        self.drop_path = StochasticDepth(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_ratio != 1:
            y = silu(self.expand_bn(self.expand(y)))
        y = silu(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(self.se(y)))
        return x + self.drop_path(y) if self.residual else y


class EfficientNetB0(nn.Module):
    def __init__(self, num_classes: int, dropout: float = 0.2,
                 drop_path_rate: float = DROP_PATH_RATE):
        super().__init__()
        self.stem = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.stem_bn = batch_norm(32, eps=BN_EPS)
        total = sum(n for _, _, n, _, _ in SETTINGS)
        cin, block = 32, 0
        for t, c, n, s, k in SETTINGS:
            for i in range(n):
                self.add_module(f"block{block}", MBConv(
                    cin, c, s if i == 0 else 1, t, k, drop_path_rate * block / total))
                cin, block = c, block + 1
        self.n_blocks = block
        self.head_conv = Conv2d(cin, 1280, 1, bias=False)
        self.head_bn = batch_norm(1280, eps=BN_EPS)
        self.dropout = Dropout(dropout)
        self.fc = Dense(1280, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = silu(self.stem_bn(self.stem(x)))
        for b in range(self.n_blocks):
            x = getattr(self, f"block{b}")(x)
        x = silu(self.head_bn(self.head_conv(x)))
        return self.dropout(global_avg_pool(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def efficientnet_b0(num_classes: int, **kw) -> EfficientNetB0:
    return EfficientNetB0(num_classes, **kw)
