"""Fine-grained Distribution Refinement (FDR) keypoint regression pieces.

Reference semantics: src/models/detrpose/transformer.py:152-260 (W(n) weighting
function, Integral softmax-expectation, distance2pose).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.graphs import device_constant


@device_constant
def weighting_function(reg_max: int, up: float, reg_scale: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Non-uniform bin-value sequence W(n), length reg_max + 1, float32.

    W spans [-2*|up|*|reg_scale|, 2*|up|*|reg_scale|] with geometric spacing that
    is denser near 0 (reference: transformer.py:152-195). Built once per
    arguments and shared by every caller: read only.
    """
    up = abs(float(up))
    reg_scale = abs(float(reg_scale))
    upper_bound1 = up * reg_scale
    upper_bound2 = up * reg_scale * 2.0
    step = (upper_bound1 + 1.0) ** (2.0 / (reg_max - 2))
    left = [-(step ** i) + 1.0 for i in range(reg_max // 2 - 1, 0, -1)]
    right = [step ** i - 1.0 for i in range(1, reg_max // 2)]
    values = [-upper_bound2] + left + [0.0] + right + [upper_bound2]
    return torch.tensor(np.array(values, dtype=np.float32), device=device)


def integral(x: torch.Tensor, project: torch.Tensor) -> torch.Tensor:
    """Expectation over the discrete FDR distribution: sum(softmax(x) * W(n)).

    The softmax and the expectation run in float32 whatever ``x``'s dtype
    (the JAX package's f32 island, fdr.py:46-48); the result is cast back.

    Args:
      x: (..., G * (reg_max+1)) logits; G groups of reg_max+1 bins each
         (G = 2 per keypoint: dx and dy).
      project: (reg_max+1,) bin values W(n).

    Returns:
      (..., G) expected offsets in ``x``'s dtype.
    """
    nbins = project.shape[0]
    lead = x.shape[:-1]
    groups = x.shape[-1] // nbins
    p = torch.softmax(x.reshape(-1, nbins).float(), dim=-1)
    e = p @ project.float()
    return e.reshape(lead + (groups,)).to(x.dtype)


def distance2pose(points: torch.Tensor, distance: torch.Tensor,
                  reg_scale: float) -> torch.Tensor:
    """Decode FDR offsets into keypoint positions: p + d / |reg_scale|.

    Args:
      points: (..., 2) initial keypoint positions (normalized).
      distance: (..., 2) decoded integral offsets.
    """
    return points + distance / abs(float(reg_scale))
