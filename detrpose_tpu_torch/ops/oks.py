"""Object Keypoint Similarity (OKS).

Counterpart of ``detrpose_tpu/ops/oks.py``; reference semantics:
src/misc/keypoint_loss.py:5-20 (oks_overlaps) and the per-dataset sigma
tables (keypoint_loss.py:49-64). Inputs use the reference's split layout:
Z = interleaved (x, y) pairs, V = per-keypoint visibility.
"""
from __future__ import annotations

import torch

from ..constants import keypoint_sigmas

__all__ = ["oks", "keypoint_sigmas", "keypoint_variances"]


def keypoint_variances(num_keypoints: int, device: torch.device | str = "cpu"
                       ) -> torch.Tensor:
    """(2 sigma)^2 per keypoint, float32 on ``device``."""
    sig = torch.from_numpy(keypoint_sigmas(num_keypoints)).to(device)
    return (2.0 * sig) ** 2


def oks(z_pred: torch.Tensor, z_gt: torch.Tensor, v_gt: torch.Tensor,
        area: torch.Tensor, num_keypoints: int, eps: float = 1e-6) -> torch.Tensor:
    """OKS between matched prediction / GT keypoint sets, in float32.

    Args:
      z_pred: (..., 2K) predicted keypoints, interleaved (x, y), normalized.
      z_gt:   (..., 2K) ground-truth keypoints, same layout.
      v_gt:   (..., K) visibility weights (0 = not annotated).
      area:   (...) instance area (normalized, as stored in targets).

    Returns:
      (...) OKS in [0, 1].
    """
    var = keypoint_variances(num_keypoints, z_pred.device)
    kp = z_pred.float().unflatten(-1, (num_keypoints, 2))
    kg = z_gt.float().unflatten(-1, (num_keypoints, 2))
    d2 = (kp[..., 0] - kg[..., 0]) ** 2 + (kp[..., 1] - kg[..., 1]) ** 2
    e = d2 / (area[..., None] * var * 2.0)
    sim = torch.exp(-e) * v_gt
    return sim.sum(dim=-1) / (v_gt.sum(dim=-1) + eps)
