"""Multi-scale deformable attention — the plain PyTorch version.

Semantics follow the reference pure-PyTorch core (src/models/detrpose/
ms_deform_attn.py:145-193): for each query, head, pyramid level and sampling
point, bilinearly sample the head's value map at ``2*loc-1`` with
``grid_sample(align_corners=False, padding_mode='zeros')``, then sum the
samples weighted by the softmaxed attention weights.

This is a direct 4-corner gather: pixel coordinates ``ix = x*W - 0.5``,
``iy = y*H - 0.5``, each corner zeroed on its own when it falls outside the
map, and the sum kept in float32 (float64 for float64 inputs). It is the
CPU path, the autograd path of the CUDA kernel (``ops/cuda/msda.py``) and
the twin that kernel is held to.
``bilinear_sample`` is the corner arithmetic; kernel #2's plain version
(``ops/cuda/msda_perquery.py``) uses it on its own packed layout, and the
plain versions of kernels #3–#5 use ``bilinear_sample_px``, the same taps at
pixel coordinates. ``corner_rows`` is its fetch of one corner, which the
plain twin of kernel #1's backward (``ops/cuda/msda.py``) shares.

The value is taken in the flattened channel-minor layout the transformer
builds anyway: ``value`` (B, S, nH*dh) with S = sum of H_l*W_l, levels in
order. ``ms_deform_attn`` keeps the JAX package's per-level signature.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

SpatialShapes = Sequence[Tuple[int, int]]


def flatten_levels(value_levels: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """Per-level (B, H, W, nH, dh) maps -> ((B, S, nH*dh), [(H, W), ...])."""
    B, _, _, nH, dh = value_levels[0].shape
    shapes = [(int(v.shape[1]), int(v.shape[2])) for v in value_levels]
    value = torch.cat([v.reshape(B, -1, nH * dh) for v in value_levels], dim=1)
    return value.contiguous(), shapes


def bilinear_sample(v: torch.Tensor, H: int, W: int, lx: torch.Tensor,
                    ly: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of one level with zeros padding.

    Args:
      v: (N, H*W, dh), the level's map per (batch, head).
      lx, ly: (N, P) float32 normalized coordinates.

    Returns:
      (N, P, dh) float32.
    """
    return bilinear_sample_px(v, H, W, lx * W - 0.5, ly * H - 0.5)


def bilinear_sample_px(v: torch.Tensor, H: int, W: int, ix: torch.Tensor,
                       iy: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample`` at pixel coordinates ``ix = x*W - 0.5``,
    ``iy = y*H - 0.5``, (N, P) float32 -> (N, P, dh) float32 (float64 from
    float64 coordinates)."""
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    sampled = 0.0
    for xc, yc, w in ((x0, y0, (x1 - ix) * (y1 - iy)),
                      (x0, y1, (x1 - ix) * (iy - y0)),
                      (x1, y0, (ix - x0) * (y1 - iy)),
                      (x1, y1, (ix - x0) * (iy - y0))):
        g, valid = corner_rows(v, H, W, xc, yc)
        sampled = sampled + g.to(ix.dtype) * (w * valid)[..., None]
    return sampled


def corner_rows(v: torch.Tensor, H: int, W: int, xc: torch.Tensor,
                yc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``v`` (N, H*W, dh) at the corners ``(xc, yc)`` (N, P),
    whole pixels, -> ((N, P, dh) in ``v``'s dtype, (N, P) bool: whether
    each corner lies in the map). A corner off the map reads a row clamped
    into it, a NaN coordinate row 0 (its weight keeps it NaN, as in JAX)."""
    valid = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1)
    xi = xc.nan_to_num(0.0).clamp(0, W - 1).long()
    yi = yc.nan_to_num(0.0).clamp(0, H - 1).long()
    idx = (yi * W + xi).unsqueeze(-1).expand(-1, -1, v.shape[-1])
    return torch.gather(v, 1, idx), valid


def ms_deform_attn_core(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain MSDA on the flattened pyramid.

    Args:
      value: (B, S, nH*dh), levels concatenated in order along S.
      spatial_shapes: [(H_l, W_l)] per level.
      sampling_locations: (B, Lq, nH, nL, nP, 2) normalized (x, y), float32.
      attention_weights: (B, Lq, nH, nL, nP).

    Returns:
      (B, Lq, nH*dh) in ``value``'s dtype.
    """
    B, Lq, nH, nL, nP, _ = sampling_locations.shape
    assert len(spatial_shapes) == nL, (spatial_shapes, nL)
    C = value.shape[-1]
    dh = C // nH
    # float32, or float64 where an input is
    acc = torch.promote_types(torch.promote_types(value.dtype, sampling_locations.dtype),
                              torch.float32)
    loc = sampling_locations.to(acc)
    aw = attention_weights.to(acc)

    out = value.new_zeros((B * nH, Lq, dh), dtype=acc)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        # (B, H*W, nH, dh) -> (B*nH, H*W, dh)
        v = value[:, start:start + H * W].reshape(B, H * W, nH, dh)
        v = v.permute(0, 2, 1, 3).reshape(B * nH, H * W, dh)
        start += H * W

        # per (b, head): the Lq*nP sample points of this level
        lx = loc[:, :, :, lvl, :, 0].permute(0, 2, 1, 3).reshape(B * nH, Lq * nP)
        ly = loc[:, :, :, lvl, :, 1].permute(0, 2, 1, 3).reshape(B * nH, Lq * nP)
        a = aw[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * nH, Lq * nP)
        sampled = bilinear_sample(v, H, W, lx, ly) * a[..., None]
        out = out + sampled.reshape(B * nH, Lq, nP, dh).sum(dim=2)

    out = out.reshape(B, nH, Lq, dh).permute(0, 2, 1, 3).reshape(B, Lq, C)
    return out.to(value.dtype)


def ms_deform_attn(
    value_levels: Sequence[torch.Tensor],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain MSDA with the JAX package's signature.

    Args:
      value_levels: per level (B, H_l, W_l, nH, dh).
      sampling_locations: (B, Lq, nH, nL, nP, 2), normalized [0, 1] (x, y).
      attention_weights: (B, Lq, nH, nL, nP), softmaxed over (levels*points).

    Returns:
      (B, Lq, nH*dh)
    """
    value, shapes = flatten_levels(value_levels)
    return ms_deform_attn_core(value, shapes, sampling_locations,
                               attention_weights)
