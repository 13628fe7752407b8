"""Sinusoidal positional embeddings (decoder query pos + encoder 2D pos).

Reference semantics:
  * decoder keypoint sine embedding: src/models/detrpose/transformer.py:518-540
  * AIFI encoder sine-HW embedding: src/models/detrpose/hybrid_encoder.py:431-460

The frequency tables are computed in float32 numpy exactly as the JAX package
computes them, so both sides start from the same constants. They are built
once per width and device and kept there (``utils/graphs.py::
device_constant``): the forward copies nothing from the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.graphs import device_constant


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """stack((x[..., 0::2].sin(), x[..., 1::2].cos()), -1).flatten(-2)."""
    s = torch.sin(x[..., 0::2])
    c = torch.cos(x[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


@device_constant
def _frequencies(hidden_dim: int, device: torch.device) -> torch.Tensor:
    """(hidden_dim // 2,) float32 10000^(2 (i // 2) / (hidden_dim // 2))."""
    half = hidden_dim // 2
    i = np.arange(half, dtype=np.float32)
    return torch.from_numpy(10000.0 ** (2.0 * (i // 2) / half)).to(device)


def sine_embedding_2d(pos: torch.Tensor, hidden_dim: int) -> torch.Tensor:
    """Decoder query positional embedding for normalized (x, y) positions.

    Args:
      pos: (..., 2) positions in [0, 1], last dim = (x, y).
      hidden_dim: output embedding width (the model width).

    Returns:
      (..., hidden_dim) embedding in ``pos``'s dtype, ordered (y-part, x-part).
    """
    dim_t = _frequencies(hidden_dim, pos.device)
    scale = 2.0 * math.pi
    px = pos[..., 0:1] * scale / dim_t
    py = pos[..., 1:2] * scale / dim_t
    return torch.cat([_interleave_sin_cos(py), _interleave_sin_cos(px)], dim=-1)


@device_constant
def sine_hw_position_embedding(
    w: int,
    h: int,
    hidden_dim: int,
    temperature_w: float = 20.0,
    temperature_h: float = 20.0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """2D sine position embedding for an (h, w) token grid.

    Returns (1, h*w, 2*hidden_dim) float32 — callers pass hidden_dim =
    model_dim // 2 so the output matches the model width
    (reference: hybrid_encoder.py:424-428). Built once per arguments and
    shared by every caller: read only.
    """
    scale = 2.0 * math.pi
    eps = 1e-6
    grid_w = np.arange(1, int(w) + 1, dtype=np.float32)
    grid_h = np.arange(1, int(h) + 1, dtype=np.float32)
    gh, gw = np.meshgrid(grid_h, grid_w, indexing="ij")  # (h, w)
    gw = gw / (int(w) + eps) * scale
    gh = gh / (int(h) + eps) * scale

    i = np.arange(hidden_dim, dtype=np.float32)
    dim_tx = temperature_w ** (2.0 * (i // 2) / hidden_dim)
    dim_ty = temperature_h ** (2.0 * (i // 2) / hidden_dim)

    pos_x = _interleave_sin_cos(torch.from_numpy(gw[..., None] / dim_tx).to(device))
    pos_y = _interleave_sin_cos(torch.from_numpy(gh[..., None] / dim_ty).to(device))
    pos = torch.cat([pos_y, pos_x], dim=-1)  # (h, w, 2*hidden_dim)
    return pos.reshape(1, h * w, -1)
