"""HGNetv2 (PP-HGNetV2) backbone, NCHW.

Counterpart of ``detrpose_tpu/models/hgnetv2.py``. Reference semantics:
src/nn/backbone/hgnetv2.py (StemBlock :169-220, HG_Block :243-329, HG_Stage
:332-383, arch table :398-476, forward :586-593). Every BatchNorm runs on its
running statistics, in training too (``freeze_norm``, the reference's
FrozenBatchNorm2d; JAX ``models/hgnetv2.py:178-181``): ``train()`` leaves the
backbone's norms in inference mode, and ``train/optim.py`` leaves their affine
parameters alone.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.graphs import GraphedStage
from .layers import BatchNorm, ConvBNAct, EseModule, LightConvBNAct

# name -> (stem_channels, [[in, mid, out, nblocks, downsample, light, k, nlayers]] per stage)
ARCH_CONFIGS = {
    "B0": ([3, 16, 16], [
        [16, 16, 64, 1, False, False, 3, 3],
        [64, 32, 256, 1, True, False, 3, 3],
        [256, 64, 512, 2, True, True, 5, 3],
        [512, 128, 1024, 1, True, True, 5, 3],
    ]),
    "B1": ([3, 24, 32], [
        [32, 32, 64, 1, False, False, 3, 3],
        [64, 48, 256, 1, True, False, 3, 3],
        [256, 96, 512, 2, True, True, 5, 3],
        [512, 192, 1024, 1, True, True, 5, 3],
    ]),
    "B2": ([3, 24, 32], [
        [32, 32, 96, 1, False, False, 3, 4],
        [96, 64, 384, 1, True, False, 3, 4],
        [384, 128, 768, 3, True, True, 5, 4],
        [768, 256, 1536, 1, True, True, 5, 4],
    ]),
    "B3": ([3, 24, 32], [
        [32, 32, 128, 1, False, False, 3, 5],
        [128, 64, 512, 1, True, False, 3, 5],
        [512, 128, 1024, 3, True, True, 5, 5],
        [1024, 256, 2048, 1, True, True, 5, 5],
    ]),
    "B4": ([3, 32, 48], [
        [48, 48, 128, 1, False, False, 3, 6],
        [128, 96, 512, 1, True, False, 3, 6],
        [512, 192, 1024, 3, True, True, 5, 6],
        [1024, 384, 2048, 1, True, True, 5, 6],
    ]),
    "B5": ([3, 32, 64], [
        [64, 64, 128, 1, False, False, 3, 6],
        [128, 128, 512, 2, True, False, 3, 6],
        [512, 256, 1024, 5, True, True, 5, 6],
        [1024, 512, 2048, 2, True, True, 5, 6],
    ]),
    "B6": ([3, 48, 96], [
        [96, 96, 192, 2, False, False, 3, 6],
        [192, 192, 512, 3, True, False, 3, 6],
        [512, 384, 1024, 6, True, True, 5, 6],
        [1024, 768, 2048, 3, True, True, 5, 6],
    ]),
}


class StemBlock(nn.Module):
    """Reference: hgnetv2.py:169-220 (asymmetric right/bottom padding)."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, use_lab: bool = False):
        super().__init__()
        self.stem1 = ConvBNAct(in_chs, mid_chs, 3, 2, use_lab=use_lab)
        self.stem2a = ConvBNAct(mid_chs, mid_chs // 2, 2, 1, use_lab=use_lab)
        self.stem2b = ConvBNAct(mid_chs // 2, mid_chs, 2, 1, use_lab=use_lab)
        self.stem3 = ConvBNAct(mid_chs * 2, mid_chs, 3, 2, use_lab=use_lab)
        self.stem4 = ConvBNAct(mid_chs, out_chs, 1, 1, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = F.pad(self.stem2a(x), (0, 1, 0, 1))
        x2 = self.stem2b(x2)
        # MaxPool2d(kernel=2, stride=1, ceil_mode=True) on the padded map
        x1 = F.max_pool2d(x, 2, stride=1)
        x = self.stem3(torch.cat([x1, x2], dim=1))
        return self.stem4(x)


class HGBlock(nn.Module):
    """Reference: hgnetv2.py:243-329; ``agg='se'`` is the HG_Stage default."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, layer_num: int,
                 kernel_size: int = 3, residual: bool = False,
                 light_block: bool = False, use_lab: bool = False, agg: str = "se"):
        super().__init__()
        self.residual = residual
        layers = []
        for i in range(layer_num):
            cin = in_chs if i == 0 else mid_chs
            if light_block:
                layers.append(LightConvBNAct(cin, mid_chs, kernel_size, use_lab=use_lab))
            else:
                layers.append(ConvBNAct(cin, mid_chs, kernel_size, 1, use_lab=use_lab))
        self.layers = nn.ModuleList(layers)
        total = in_chs + layer_num * mid_chs
        if agg == "se":
            self.aggregation = nn.Sequential(
                ConvBNAct(total, out_chs // 2, 1, 1, use_lab=use_lab),
                ConvBNAct(out_chs // 2, out_chs, 1, 1, use_lab=use_lab))
        else:
            self.aggregation = nn.Sequential(
                ConvBNAct(total, out_chs, 1, 1, use_lab=use_lab),
                EseModule(out_chs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        outs = [x]
        for layer in self.layers:
            x = layer(x)
            outs.append(x)
        y = self.aggregation(torch.cat(outs, dim=1))
        return y + identity if self.residual else y


class HGStage(nn.Module):
    """Reference: hgnetv2.py:332-383."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, block_num: int,
                 layer_num: int, downsample: bool = True, light_block: bool = False,
                 kernel_size: int = 3, use_lab: bool = False):
        super().__init__()
        self.downsample = (ConvBNAct(in_chs, in_chs, 3, 2, groups=in_chs,
                                     use_act=False, use_lab=use_lab)
                           if downsample else None)
        self.blocks = nn.Sequential(*[
            HGBlock(in_chs if i == 0 else out_chs, mid_chs, out_chs, layer_num,
                    kernel_size=kernel_size, residual=i > 0,
                    light_block=light_block, use_lab=use_lab)
            for i in range(block_num)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class HGNetv2(GraphedStage):
    """Multi-scale CNN backbone; returns the features of the stages in
    ``return_idx`` (strides 4/8/16/32). Reference: hgnetv2.py:386-593.
    Its eval forward on the card replays a CUDA graph
    (``utils/graphs.py::GraphedStage``).

    ``remat`` recomputes each stage in the backward pass of training
    (``torch.utils.checkpoint``; JAX ``nn.remat`` of ``HGStage``): memory for
    operations. Its norms are frozen, so a recomputed stage moves no statistics.
    """

    def __init__(self, arch: str = "B4", use_lab: bool = False,
                 return_idx: Sequence[int] = (1, 2, 3), remat: bool = False):
        super().__init__()
        stem_channels, stage_config = ARCH_CONFIGS[arch]
        self.return_idx = tuple(return_idx)
        self.remat = remat
        self.stem = StemBlock(*stem_channels, use_lab=use_lab)
        self.stages = nn.ModuleList(
            HGStage(cin, cmid, cout, nblocks, nlayers, downsample=down,
                    light_block=light, kernel_size=k, use_lab=use_lab)
            for cin, cmid, cout, nblocks, down, light, k, nlayers in stage_config)

    def train(self, mode: bool = True) -> "HGNetv2":
        super().train(mode)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.eval()
        return self

    def run(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            if self.remat and self.training and torch.is_grad_enabled():
                x = checkpoint(stage, x, use_reentrant=False)
            else:
                x = stage(x)
            if i in self.return_idx:
                outs.append(x)
        return outs
