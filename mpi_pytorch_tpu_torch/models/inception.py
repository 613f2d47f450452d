"""Inception-v3 (``mpi_pytorch_tpu/models/inception.py``) at 299 px, with
the auxiliary classifier.

``BasicConv`` is an unbiased convolution, batchnorm with ε = 1e-3 and
momentum 0.1 (flax's 0.9), and relu. Blocks A to E follow the JAX
module's branches; their 3×3/s1/p1 average pools count the zero padding
(flax ``avg_pool``'s default), their 3×3/s2 max pools are ``'VALID'``.
There is no ``transform_input``, as in JAX.

In train mode the model also runs ``AuxLogits`` (an ``InceptionAux`` over
the Mixed_6e map: 5×5/s3 average pool, two BasicConvs, the adaptive 1×1
pool and its dense head ``AuxLogits.fc``, flax ``AuxLogits/aux_head``) and
returns ``(logits, aux)``; the loss adds 0.4·CE(aux)
(``ops/losses.classification_loss``). In eval mode it returns the logits
alone and never runs the auxiliary branch. ``features`` (eval) is the
forward up to the head's input, the pooled [B, 2048] after dropout.

State names follow the JAX module's (``Conv2d_1a_3x3.conv``/``.bn``,
``Mixed_5b.branch1x1.conv`` …); the head is ``fc``.
"""

from __future__ import annotations

import torch
from torch import nn

from mpi_pytorch_tpu_torch.models.common import (
    Conv2d,
    Dense,
    Dropout,
    adaptive_avg_pool,
    avg_pool,
    batch_norm,
    global_avg_pool,
    max_pool,
)

BN_EPS = 1e-3


def _pair(v) -> tuple[int, int]:
    return v if isinstance(v, tuple) else (v, v)


class BasicConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, _pair(kernel), stride=stride, padding=_pair(padding),
                           bias=False)
        self.bn = batch_norm(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(avg_pool(x, 3, 1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv(cin, 128, 1)
        self.conv1 = BasicConv(128, 768, 5)
        self.fc = Dense(768, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(self.conv0(avg_pool(x, 5, 3)))
        return self.fc(torch.flatten(adaptive_avg_pool(x, (1, 1)), 1))


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int, aux_logits: bool = True, dropout_rate: float = 0.5):
        super().__init__()
        self.aux_logits = aux_logits
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        if aux_logits:
            self.AuxLogits = InceptionAux(768, num_classes)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.dropout = Dropout(dropout_rate)
        self.fc = Dense(2048, num_classes)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        x = max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x

    def _head_input(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return self.dropout(global_avg_pool(x))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self._head_input(self._trunk(x))

    def forward(self, x: torch.Tensor):
        x = self._trunk(x)
        aux = self.AuxLogits(x) if self.aux_logits and self.training else None
        logits = self.fc(self._head_input(x))
        return logits if aux is None else (logits, aux)


def inception_v3(num_classes: int, **kw) -> InceptionV3:
    return InceptionV3(num_classes, **kw)
