"""The reference's serving path: a uint8 frame batch resized to the model's
square input and run through the model, its query selection optionally
taken from elsewhere (the run under judgement). Semantics of the reference
DETRPose's tools/inference/torch_inf.py: a square resize, bilinear with
antialiasing, values in [0, 1]."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def preprocess(frames: np.ndarray, res: int, device: torch.device | str) -> torch.Tensor:
    """(B, H, W, 3) or (H, W, 3) uint8 -> (B, 3, res, res) float32."""
    x = torch.as_tensor(np.asarray(frames)).to(device)
    if x.dim() == 3:
        x = x[None]
    x = x.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False,
                         antialias=True)


@torch.no_grad()
def features(net, frames: np.ndarray, res: int, device) -> list:
    """The encoder's pyramid of a frame batch: what does not depend on the
    query selection."""
    x = preprocess(frames, res, device).to(next(net.parameters()).dtype)
    return net.encoder(net.backbone(x))


@torch.no_grad()
def decode_from(net, feats: list, topk_idx: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The transformer's eval outputs on ``feats``, with the query selection
    ``topk_idx`` (B, nq) if given; ``scores`` are the encoder's class scores
    (B, S, C) the selection ranks, as the reference computed them."""
    out = net.transformer(feats, topk_idx)
    return {"pred_logits": out["pred_logits"], "pred_keypoints": out["pred_keypoints"],
            "scores": net.transformer.last_enc_class}
