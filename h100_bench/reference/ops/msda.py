"""Multi-scale deformable attention by ``F.grid_sample``, the reference
DETRPose's own pure-PyTorch core (src/models/detrpose/ms_deform_attn.py):
per level, each head's value map sampled bilinearly at ``2 * loc - 1`` with
zeros padding and ``align_corners=False``, weighted and summed over levels
and points. Computed in float32."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn_grid_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                               loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """value (B, S, nH*dh), levels in order; loc (B, Lq, nH, nL, nP, 2) in
    [0, 1] as (x, y); aw (B, Lq, nH, nL, nP) -> (B, Lq, nH*dh) in value's dtype."""
    B, Lq, nH, nL, nP, _ = loc.shape
    C = value.shape[-1]
    dh = C // nH
    levels = value.float().split([int(h) * int(w) for h, w in spatial_shapes], dim=1)
    grids = 2.0 * loc.float() - 1.0
    out = value.new_zeros((B * nH, dh, Lq), dtype=torch.float32)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = levels[lvl].reshape(B, h * w, nH, dh).permute(0, 2, 3, 1).reshape(B * nH, dh, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * nH, Lq, nP, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        a = aw[:, :, :, lvl].float().transpose(1, 2).reshape(B * nH, 1, Lq, nP)
        out = out + (s * a).sum(-1)
    return out.reshape(B, nH * dh, Lq).transpose(1, 2).to(value.dtype)
