"""DETRPose top module: backbone -> hybrid encoder -> pose transformer.

Counterpart of ``detrpose_tpu/models/detrpose.py``; reference:
src/models/detrpose/detrpose.py:15-81. ``model.eval()`` gives the serving
forward, ``model.train()`` the training forward with its deep-supervision and
denoising outputs (the backbone's norms stay frozen, ``models/hgnetv2.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder
from .layers import FastKANLayer
from .transformer import Transformer


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``model`` from ``generator``, then apply the
    reference's fixed head inits (``init_heads_`` of the modules that have one).

    Linear and conv layers draw from PyTorch's default uniform(+-1/sqrt(fan_in)),
    the packed attention projections and the embeddings from xavier-uniform,
    FastKAN's coefficients from normal(1e-2);
    norms keep unit scale and zero shift, BatchNorm statistics mean 0, var 1.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.MultiheadAttention):
                nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
                nn.init.zeros_(m.in_proj_bias)
            elif isinstance(m, nn.Embedding):
                nn.init.xavier_uniform_(m.weight, generator=generator)
            elif isinstance(m, FastKANLayer):
                m.coeffs.normal_(0.0, m.init_scale, generator=generator)
        for m in model.modules():
            if hasattr(m, "init_heads_"):
                m.init_heads_()


class DETRPose(nn.Module):

    def __init__(self, backbone: HGNetv2, encoder: HybridEncoder,
                 transformer: Transformer):
        super().__init__()
        self.backbone = backbone
        self.encoder = encoder
        self.transformer = transformer

    def forward(self, samples: torch.Tensor,
                dn: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """samples (B, 3, H, W) in [0, 1]; ``dn`` the denoising batch of
        ``train/cdn.py::cdn_to_device``, read in training only.

        Eval -> {pred_logits, pred_keypoints}; training -> the train dict of
        ``models/transformer.py::Transformer.forward``."""
        return self.transformer(self.encoder(self.backbone(samples)), dn)
