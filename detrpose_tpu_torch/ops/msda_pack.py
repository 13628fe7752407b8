"""Packings of the MSDA variant tools (kernels #3–#5).

Counterparts of the packing in ``tools_local_msda_v2.py`` (``pack_points``
:67-82, the value packings :130-132 and :196-198, the column planes :90) and
``tools_local_msda_ablate.py`` (:85-105). The tools sample **per point**:
point ``p = q*nP + k`` of query q and point k, at pixel coordinates
``ix = x*W - 0.5``, ``iy = y*H - 0.5`` of each level. The TPU tools pad the
points of one (image, head) up to a multiple of their tile (512) and cut them
into ``(B, nH*n_t, 1, TP)`` blocks; that padding is Mosaic's alignment rule
and is dropped here: each per-level array is ``(B, nH, P)``, ``P = Lq*nP``.

Every function works on the device of the tensors it is given (the column
planes on the device it is told); nothing moves between devices.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

LevelShapes = Sequence[Tuple[int, int]]


def level_shapes(value_levels: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
    """[(H, W), ...] of per-level (B, H, W, nH, dh) maps."""
    return [(int(v.shape[1]), int(v.shape[2])) for v in value_levels]


def pack_points(sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                shapes: LevelShapes) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Locations (B, Lq, nH, nL, nP, 2) and weights (B, Lq, nH, nL, nP) ->
    per level (ix, iy, a), each float32 (B, nH, Lq*nP), contiguous, in pixel
    coordinates of that level."""
    B, Lq, nH, nL, nP, _ = sampling_locations.shape
    if len(shapes) != nL:
        raise ValueError(f"{len(shapes)} level shapes for {nL} levels")

    def pack(t):
        return t.float().transpose(1, 2).reshape(B, nH, Lq * nP).contiguous()

    loc = sampling_locations.float()
    return [(pack(loc[:, :, :, lvl, :, 0] * W - 0.5), pack(loc[:, :, :, lvl, :, 1] * H - 0.5),
             pack(attention_weights[:, :, :, lvl]))
            for lvl, (H, W) in enumerate(shapes)]


def pack_values_xminor(value_levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per level (B, H, W, nH, dh) -> bf16 (B, nH, H, W*dh): row y holds the
    channels of x = 0, 1, ... in turn (v2.py:130-132, ablate.py:101-102)."""
    out = []
    for v in value_levels:
        B, H, W, nH, dh = v.shape
        out.append(v.permute(0, 3, 1, 2, 4).reshape(B, nH, H, W * dh)
                   .to(torch.bfloat16).contiguous())
    return out


def pack_values_tposed(value_levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per level (B, H, W, nH, dh) -> bf16 (B, nH, W*dh, H): row x*dh + d
    holds channel d of column x over y (v2.py:196-198)."""
    out = []
    for v in value_levels:
        B, H, W, nH, dh = v.shape
        out.append(v.permute(0, 3, 2, 4, 1).reshape(B, nH, W * dh, H)
                   .to(torch.bfloat16).contiguous())
    return out


def unpack_output(out: torch.Tensor, nP: int, transposed: bool = False) -> torch.Tensor:
    """Per-point output (B, nH, P, dh), or (B, nH, dh, P) when ``transposed``
    -> (B, Lq, nH*dh), each query's nP points summed (v2.py:144-146,
    :210-212)."""
    if transposed:
        out = out.transpose(2, 3)
    B, nH, P, dh = out.shape
    Lq = P // nP
    return out.reshape(B, nH, Lq, nP, dh).sum(3).transpose(1, 2).reshape(B, Lq, nH * dh)


def column_planes(shapes: LevelShapes, dh: int, device: torch.device | str
                  ) -> List[torch.Tensor]:
    """Per level the column-index plane (1, W*dh) float32, entry j = j // dh,
    the precomputed input of the ``colsin`` variant (v2.py:90-91)."""
    return [(torch.arange(W * dh, device=device) // dh).float()[None, :] for _, W in shapes]
