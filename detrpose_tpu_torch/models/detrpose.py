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

from ..utils.measure import span
from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder
from .layers import FastKANLayer
from .transformer import Transformer


# flax's lecun_normal (``variance_scaling(1, "fan_in", "truncated_normal")``):
# a normal cut at +-2 sigma, its sigma raised by 1 / std(N(0, 1) cut at +-2)
# so that the drawn values have std 1/sqrt(fan_in)
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Fill ``w`` from flax's default kernel init for ``fan_in`` inputs."""
    std = 1.0 / math.sqrt(fan_in) / TRUNCATED_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``model`` from ``generator`` as JAX ``model.init``
    draws it, then apply the fixed head inits (``init_heads_`` of the modules
    that have one).

    Linear and conv weights (attention output projections included) draw from
    flax's lecun-normal with fan_in = ``w[0].numel()``, which is flax's
    (kh * kw * in / groups for a conv); their biases are zero, flax's default.
    The packed attention in-projection (3d, d) is JAX's three (d, d) lecun
    kernels stacked, with zero bias. The query and denoising embeddings draw
    from xavier-uniform (JAX transformer.py:135-141), FastKAN's coefficients
    from normal(``init_scale``). Norms keep unit scale and zero shift,
    BatchNorm statistics mean 0 and var 1, and the LAB affine, the
    modulation bias and the energy step size their constructor values.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.MultiheadAttention):
                lecun_normal_(m.in_proj_weight, m.embed_dim, generator)
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
        with span("detrpose.backbone"):
            feats = self.backbone(samples)
        with span("detrpose.encoder"):
            feats = self.encoder(feats)
        with span("detrpose.transformer"):
            return self.transformer(feats, dn)
