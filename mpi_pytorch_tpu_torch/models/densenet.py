"""DenseNet (``mpi_pytorch_tpu/models/densenet.py``), densenet121 by
default: the 7×7/s2 stem conv, ``norm0``·relu·3×3/s2/p1 max pool, dense
blocks of BN-relu-1×1-BN-relu-3×3 layers each concatenating its growth
onto its input, transitions (BN-relu-1×1 conv halving the channels, 2×2
average pool), ``norm5``·relu, the global pool and the head ``fc``.

With ``fused_stem`` the stem tail ``norm0``·relu·max pool is
:class:`~mpi_pytorch_tpu_torch.models.common.FusedStemBNReluPool` — the
same stem geometry as resnet's, so the fused stem kernels run on it (the
training forward and index backward in training, the eval forward in
evaluation and validation) — with the state names of the plain batchnorm.

State names follow the JAX module's: ``conv0``, ``norm0``,
``denseblock{i}_layer{j}.{norm1,conv1,norm2,conv2}``,
``transition{i}.{norm,conv}``, ``norm5``; the head is ``fc``. The factory
takes ``block_config``, ``growth_rate`` and ``num_init_features``, so a
test can build it small.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    FusedStemBNReluPool,
    avg_pool,
    batch_norm,
    global_avg_pool,
    max_pool,
)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = batch_norm(cin)
        self.conv1 = Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.norm2 = batch_norm(bn_size * growth_rate)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = Conv2d(cin, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int], num_classes: int, growth_rate: int = 32,
                 num_init_features: int = 64, fused_stem: bool = False):
        super().__init__()
        self.fused_stem = fused_stem
        self.conv0 = Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False)
        self.norm0 = (FusedStemBNReluPool(num_init_features) if fused_stem
                      else batch_norm(num_init_features))
        self.layers = []
        features = num_init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                name = f"denseblock{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(features, growth_rate))
                self.layers.append(name)
                features += growth_rate
            if i != len(block_config) - 1:
                name = f"transition{i + 1}"
                self.add_module(name, Transition(features, features // 2))
                self.layers.append(name)
                features //= 2
        self.norm5 = batch_norm(features)
        self.fc = Dense(features, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x)
        x = self.norm0(x) if self.fused_stem else max_pool(torch.relu(self.norm0(x)), 3, 2, padding=1)
        for name in self.layers:
            x = getattr(self, name)(x)
        return global_avg_pool(torch.relu(self.norm5(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


def densenet121(num_classes: int, *, block_config: Sequence[int] = (6, 12, 24, 16),
                growth_rate: int = 32, num_init_features: int = 64,
                fused_stem: bool = False) -> DenseNet:
    return DenseNet(block_config, num_classes, growth_rate=growth_rate,
                    num_init_features=num_init_features, fused_stem=fused_stem)
