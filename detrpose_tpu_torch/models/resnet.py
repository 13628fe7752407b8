"""ResNet-50/101 backbone, NCHW.

Counterpart of ``detrpose_tpu/models/resnet.py``. Reference:
src/nn/backbone/resnet.py:61-100 (torchvision's ResNet, present in the
reference but used by none of its shipped configs), selected by
``backbone_name="resnet50"`` or ``"resnet101"``. Module names follow the JAX
package's parameter tree as ``utils/convert.py`` maps it: ``conv1``, ``bn1``
and ``layer{stage}_{block}``, each BatchNorm's tensors under ``<name>.bn``.
Its norms behave as the JAX ResNet's: batch statistics in training, running
ones at eval.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Norm(nn.Module):
    """A ``BatchNorm`` under the child name ``bn``, as JAX's wrapper module."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class Bottleneck(nn.Module):
    """1x1, 3x3 (the stride), 1x1 to 4x the planes; a 1x1 projection of the
    identity on a stage's first block."""

    def __init__(self, in_chs: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chs, planes, 1, bias=False)
        self.bn1 = Norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = Norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = Norm(planes * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_chs, planes * 4, 1, stride, bias=False)
            self.downsample_bn = Norm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if hasattr(self, "downsample_conv") else x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-50 (``depth=50``) or -101 returning the stages in
    ``return_idx`` (1, 2, 3: C3/C4/C5 at strides 8/16/32)."""

    def __init__(self, depth: int = 50, return_idx: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.return_idx = tuple(return_idx)
        self.blocks = DEPTHS[depth]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = Norm(64)
        in_chs = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), self.blocks)):
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        Bottleneck(in_chs, planes, stride, downsample=b == 0))
                in_chs = planes * 4

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        # the 3x3 stride-2 max-pool on a -inf pad of 1
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage, n in enumerate(self.blocks):
            for b in range(n):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            if stage in self.return_idx:
                outs.append(x)
        return outs
