"""Per-keypoint OKS falloff sigmas (COCO 17, CrowdPose 14, 3-point).

An own copy of ``detrpose_tpu/constants.py``; reference: src/misc/
keypoint_loss.py:49-64. Numpy only, so the host-side CDN builder needs no
torch import.
"""
from __future__ import annotations

import numpy as np

_SIGMAS_17 = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07,
     1.07, 0.87, 0.87, 0.89, 0.89],
    dtype=np.float32,
) / 10.0
_SIGMAS_14 = np.array(
    [0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89,
     0.79, 0.79],
    dtype=np.float32,
) / 10.0
_SIGMAS_3 = np.array([1.07, 1.07, 0.67], dtype=np.float32) / 10.0


def keypoint_sigmas(num_keypoints: int) -> np.ndarray:
    """Per-keypoint COCO / CrowdPose falloff sigmas, float32."""
    if num_keypoints == 17:
        return _SIGMAS_17
    if num_keypoints == 14:
        return _SIGMAS_14
    if num_keypoints == 3:
        return _SIGMAS_3
    raise ValueError(f"Unsupported keypoints number {num_keypoints}")
