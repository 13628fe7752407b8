"""HybridEncoder: AIFI transformer on the coarsest level + CSP-PAN fusion.

Counterpart of ``detrpose_tpu/models/hybrid_encoder.py``. Reference semantics:
src/models/detrpose/hybrid_encoder.py:324-507 — per-level 1x1 conv + BN
projection, a post-norm transformer encoder over the flattened stride-32
tokens with a 2D sine position embedding, then the top-down FPN (lateral 1x1,
nearest 2x upsample, RepNCSPELAN4) and the bottom-up PAN (SCDown,
RepNCSPELAN4). Feature maps are NCHW. In training (``self.training``) every
norm here normalises with the batch statistics and moves its running ones
(``models/layers.py::BatchNorm``). ``deploy=True`` builds the FPN/PAN's
re-parameterised form (hybrid_encoder.py:68, 118-129 of the JAX package),
whose weights ``utils/deploy.py::fuse_for_deploy`` makes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pos_embed import sine_hw_position_embedding
from ..utils.graphs import GraphedStage
from ..utils.measure import span
from .layers import (BatchNorm, ConvNormLayer, MultiheadAttention, RepNCSPELAN4,
                     SCDown, get_activation)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer. Reference: hybrid_encoder.py:244-296."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "gelu"):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.activation = get_activation(activation)

    def forward(self, src: torch.Tensor,
                pos_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = k = src if pos_embed is None else src + pos_embed
        src = self.norm1(src + self.self_attn(q, k, src))
        ff = self.linear2(self.activation(self.linear1(src)))
        return self.norm2(src + ff)


class _Encoder(nn.Module):
    """Holder of one AIFI encoder's layers (state_dict ``encoder.{i}.layers.{j}``)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class HybridEncoder(GraphedStage):
    """Reference: hybrid_encoder.py:324-507. Its eval forward on the card
    replays a CUDA graph (``utils/graphs.py::GraphedStage``)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), n_levels: int = 3,
                 hidden_dim: int = 256, nhead: int = 8, dim_feedforward: int = 1024,
                 enc_act: str = "gelu", use_encoder_idx: Sequence[int] = (2,),
                 num_encoder_layers: int = 1, expansion: float = 1.0,
                 depth_mult: float = 1.0, act: str = "silu",
                 temperature_w: float = 20.0, temperature_h: float = 20.0,
                 deploy: bool = False):
        super().__init__()
        assert len(in_channels) == n_levels
        hd = hidden_dim
        self.hidden_dim = hd
        self.n_levels = n_levels
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.temperature_w = temperature_w
        self.temperature_h = temperature_h

        self.input_proj = nn.ModuleList(
            nn.Sequential(OrderedDict(conv=nn.Conv2d(c, hd, 1, bias=False),
                                      norm=BatchNorm(hd)))
            for c in in_channels)
        self.encoder = nn.ModuleList(
            _Encoder([TransformerEncoderLayer(hd, nhead, dim_feedforward, enc_act)
                      for _ in range(num_encoder_layers)])
            for _ in self.use_encoder_idx)

        n_blocks = round(3 * depth_mult)
        c4 = round(expansion * hd // 2)
        self.lateral_convs = nn.ModuleList(
            ConvNormLayer(hd, hd, 1, 1, act=act) for _ in range(n_levels - 1))
        self.fpn_blocks = nn.ModuleList(
            RepNCSPELAN4(2 * hd, hd, 2 * hd, c4, n_blocks, act=act, deploy=deploy)
            for _ in range(n_levels - 1))
        self.downsample_convs = nn.ModuleList(
            nn.Sequential(SCDown(hd, hd, 3, 2, deploy=deploy)) for _ in range(n_levels - 1))
        self.pan_blocks = nn.ModuleList(
            RepNCSPELAN4(2 * hd, hd, 2 * hd, c4, n_blocks, act=act, deploy=deploy)
            for _ in range(n_levels - 1))

    def run(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        assert len(feats) == self.n_levels
        proj = [p(f) for p, f in zip(self.input_proj, feats)]

        # AIFI encoder on the selected level(s)
        for enc, enc_idx in zip(self.encoder, self.use_encoder_idx):
            with span("encoder.aifi"):
                x = proj[enc_idx]
                B, C, H, W = x.shape
                src = x.flatten(2).transpose(1, 2)                  # (B, H*W, C)
                pos = sine_hw_position_embedding(
                    W, H, self.hidden_dim // 2, self.temperature_w,
                    self.temperature_h, device=x.device).to(src.dtype)
                for layer in enc.layers:
                    src = layer(src, pos)
                proj[enc_idx] = src.transpose(1, 2).reshape(B, C, H, W)

        with span("encoder.fusion"):
            # top-down FPN
            inner_outs = [proj[-1]]
            for k, idx in enumerate(range(self.n_levels - 1, 0, -1)):
                feat_high = self.lateral_convs[k](inner_outs[0])
                inner_outs[0] = feat_high
                up = F.interpolate(feat_high, scale_factor=2.0, mode="nearest")
                inner = self.fpn_blocks[k](torch.cat([up, proj[idx - 1]], dim=1))
                inner_outs.insert(0, inner)

            # bottom-up PAN
            outs = [inner_outs[0]]
            for idx in range(self.n_levels - 1):
                down = self.downsample_convs[idx](outs[-1])
                outs.append(self.pan_blocks[idx](
                    torch.cat([down, inner_outs[idx + 1]], dim=1)))
        return outs
