"""Small shared numeric helpers."""
from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Logit with the reference's clamping (src/models/detrpose/utils.py:133-137)."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)
