"""DETRPose top module: backbone -> hybrid encoder -> pose transformer.

Reference:
src/models/detrpose/detrpose.py:15-81; the serving forward (``model.eval()``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder
from .transformer import Transformer


class DETRPose(nn.Module):

    def __init__(self, backbone: HGNetv2, encoder: HybridEncoder,
                 transformer: Transformer):
        super().__init__()
        self.backbone = backbone
        self.encoder = encoder
        self.transformer = transformer

    def forward(self, samples: torch.Tensor, topk_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """samples (B, 3, H, W) in [0, 1] -> {pred_logits, pred_keypoints};
        ``topk_idx`` as ``Transformer.forward``'s."""
        return self.transformer(self.encoder(self.backbone(samples)), topk_idx)
