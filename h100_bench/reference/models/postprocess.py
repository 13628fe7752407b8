"""NMS-free top-k decode of the model outputs.

Counterpart of ``detrpose_tpu/models/postprocess.py``; reference:
src/models/detrpose/postprocesses.py:6-45.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def postprocess(outputs: Dict[str, torch.Tensor], target_sizes: torch.Tensor,
                num_select: int = 60, num_body_points: int = 17
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode (scores, labels, keypoints) from raw model outputs.

    Args:
      outputs: ``pred_logits`` (B, nq, C) and ``pred_keypoints`` (B, nq, 2K),
        normalized.
      target_sizes: (B, 2) original (w, h) of each image.

    Returns:
      scores (B, num_select); labels (B, num_select) int64; keypoints
      (B, num_select, K, 3) as (x, y, visibility=1) in original image pixels.
    """
    logits = outputs["pred_logits"]
    kpts = outputs["pred_keypoints"]
    B, nq, C = logits.shape
    K = num_body_points

    prob = torch.sigmoid(logits).reshape(B, nq * C)
    scores, topk_idx = prob.topk(num_select, dim=1)
    topk_query = topk_idx // C
    labels = topk_idx % C

    sel = kpts.gather(1, topk_query[..., None].expand(-1, -1, kpts.shape[-1]))
    sel = sel.reshape(B, num_select, K, 2) * target_sizes[:, None, None, :].to(kpts.dtype)
    vis = torch.ones_like(sel[..., :1])
    return scores, labels, torch.cat([sel, vis], dim=-1)
