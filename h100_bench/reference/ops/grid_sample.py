"""Bilinear grid sampling with ``F.grid_sample`` semantics on NHWC or NCHW maps.

Counterpart of ``detrpose_tpu/ops/grid_sample.py``: ``mode='bilinear'``,
``padding_mode='zeros'``, ``align_corners=False`` — the configuration of the
reference LQE head (src/models/detrpose/transformer.py:278-280). With zero
padding each of the four corner taps is zeroed on its own when it falls
outside the map; the sample as a whole is not masked. ``F.grid_sample`` does
exactly that, so the library call is the op. It runs in float32, so that
sample positions are not rounded to a 16-bit working dtype; the result is cast
back to the map's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_grid_sample_nchw(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample an NCHW ``feat`` (B, C, H, W) at ``grid`` (B, ..., 2), last dim
    (x, y) in [-1, 1]. Returns (B, ..., C) in ``feat``'s dtype, zero outside."""
    B, C = feat.shape[:2]
    out_shape = grid.shape[:-1] + (C,)
    g = grid.reshape(B, 1, -1, 2).float()
    out = F.grid_sample(feat.float(), g, mode="bilinear", padding_mode="zeros",
                        align_corners=False)                 # (B, C, 1, N)
    return out[:, :, 0].transpose(1, 2).reshape(out_shape).to(feat.dtype)


def bilinear_grid_sample(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The JAX package's signature: NHWC ``feat`` (B, H, W, C), ``grid``
    (B, ..., 2) in [-1, 1] -> (B, ..., C), zero outside the map."""
    return bilinear_grid_sample_nchw(feat.permute(0, 3, 1, 2), grid)
