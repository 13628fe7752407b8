"""MSDA per sampling point, the ``colsin`` variant — wrapper of
``csrc/msda_colsin.cu``.

Port of the TPU kernel ``tools_local_msda_v2.py::build_colsin`` (kernel :93,
``pallas_call`` :133), a variant of the separable MSDA kernel that takes its
column-index plane as a precomputed input. It computes MSDA **per sampling
point**, ``out[b, h, p, :] = sum_l a_l * (bilinear sample of level l at
(ix_l, iy_l))``, with no sum over the nP points of a query; the op around it
sums them. Kernel #4 (``msda_tpose.py``) is the same function in the
transposed layout, kernel #5 (``msda_ablate.py``) its stage ablations.

``msda_colsin`` takes the packed layout of ``ops/msda_pack.py`` and picks its
path by device: on a CUDA tensor it launches the kernel with ``tile`` points
per block (the counterpart of the TPU's point tile TP) or raises, on a CPU
tensor it runs ``msda_colsin_plain``. ``msda_colsin.launches`` counts kernel
launches and nothing else. The launch is ``ops/cuda/msda.py::point_plan``'s,
as for kernel #5: the widest load every level's map allows, ``dh / vec``
threads a point. The column planes are checked and passed as the TPU kernel
is given them; the CUDA kernel takes each tap's column from ``ix`` and does
not read them (see the source's header).

``ms_deform_attn_colsin`` is the tool's op (v2.py:128-146): the JAX
signature, the values cast to bf16 as the TPU op casts them, the packing, the
kernel, the nP sum, and (B, Lq, nH*dh) in the values' dtype. There is no
gradient: the TPU kernel has none.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample_px
from ..msda_pack import (column_planes, level_shapes, pack_points, pack_values_xminor,
                         unpack_output)
from .msda import POINT_ARGTYPES, PointPlan, bind, check_points, launch_points, point_plan

TILE = 256           # points per block: kernel #5 `full` ran fastest at 256 (PERF.md)


def _load():
    # the point table, out, B*nH, P, nL, dh, then the tile, the channels per
    # thread, the stream
    return bind("msda_colsin.cu", ("msda_colsin",),
                POINT_ARGTYPES[:-1] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def xminor_dims(H: int, W: int, dh: int):
    """Trailing dims of one level's x-minor value map."""
    return (H, W * dh)


def msda_colsin_plain(points, values: Sequence[torch.Tensor],
                      shapes: SpatialShapes) -> torch.Tensor:
    """The plain version: per level (ix, iy, a) float32 (B, nH, P) in pixel
    coordinates and the x-minor map (B, nH, H, W*dh) -> (B, nH, P, dh)
    float32, each point's bilinear samples weighted and summed over levels."""
    B, nH, P = points[0][0].shape
    out = 0.0
    for (ix, iy, a), v, (H, W) in zip(points, values, shapes):
        v = v.reshape(B * nH, H * W, -1)
        s = bilinear_sample_px(v, H, W, ix.reshape(B * nH, P), iy.reshape(B * nH, P))
        out = out + s * a.reshape(B * nH, P, 1)
    return out.reshape(B, nH, P, -1)


class MSDAColsin:
    """The per-point MSDA on x-minor rows; ``launches`` counts CUDA kernel
    launches."""

    def __init__(self):
        self.launches = 0

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, points, values: Sequence[torch.Tensor], cols: Sequence[torch.Tensor],
                 shapes: SpatialShapes, tile: int = TILE) -> torch.Tensor:
        """``points`` per level (ix, iy, a), ``values`` per level x-minor maps,
        ``cols`` per level the (1, W*dh) column planes -> (B, nH, P, dh) float32."""
        dev = points[0][0].device
        if dev.type == "cpu":
            return msda_colsin_plain(points, values, shapes)
        if dev.type != "cuda":
            raise ValueError(f"msda_colsin: unsupported device {dev}")
        dh = self._check(points, values, cols, shapes, tile)
        B, nH, P = points[0][0].shape
        out = torch.empty((B, nH, P, dh), dtype=torch.float32, device=dev)
        if out.numel():
            plan = self.plan(values, dh, P, tile)
            launch_points("msda_colsin", _load()[0].msda_colsin, points, values, shapes,
                          out, dh, tile, plan.vec)
            self.launches += 1
        return out

    @staticmethod
    def plan(values: Sequence[torch.Tensor], dh: int, P: int, tile: int = TILE) -> PointPlan:
        """The kernel's launch for these maps and ``P`` points per (image, head);
        raises where a point needs more threads than a block has."""
        return point_plan(dh, 2, [v.data_ptr() for v in values], P, tile)

    @staticmethod
    def _check(points, values, cols, shapes, tile: int = TILE) -> int:
        """Raises on what the kernel does not take; returns dh."""
        dh = values[0].shape[-1] // int(shapes[0][1]) if shapes else 0
        check_points("msda_colsin", points, values, shapes, dh, xminor_dims)
        if dh < 1:
            raise ValueError(f"msda_colsin: head width {dh}")
        if not isinstance(tile, int) or tile < 1:
            raise ValueError(f"msda_colsin: tile must be a positive int, got {tile!r}")
        try:
            MSDAColsin.plan(values, dh, points[0][0].shape[-1], tile)
        except ValueError as e:
            raise ValueError(f"msda_colsin: {e}") from None
        if len(cols) != len(shapes):
            raise ValueError(f"msda_colsin: {len(cols)} column planes for "
                             f"{len(shapes)} levels")
        for c, (_, W) in zip(cols, shapes):
            if (c.dtype != torch.float32 or tuple(c.shape) != (1, int(W) * dh)
                    or c.device != points[0][0].device):
                raise ValueError(f"msda_colsin: a column plane must be float32 "
                                 f"(1, W*dh) = (1, {int(W) * dh}) on the points' device, "
                                 f"got {c.dtype} {tuple(c.shape)} on {c.device}")
        return dh


msda_colsin = MSDAColsin()


def ms_deform_attn_colsin(value_levels: Sequence[torch.Tensor],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """The tool's op: per-level (B, H, W, nH, dh) values, locations
    (B, Lq, nH, nL, nP, 2) and weights (B, Lq, nH, nL, nP) -> (B, Lq, nH*dh)
    in the values' dtype."""
    shapes = level_shapes(value_levels)
    dh = value_levels[0].shape[-1]
    points = pack_points(sampling_locations, attention_weights, shapes)
    values = pack_values_xminor(value_levels)
    cols = column_planes(shapes, dh, values[0].device)
    out = msda_colsin(points, values, cols, shapes)
    return unpack_output(out, sampling_locations.shape[4]).to(value_levels[0].dtype)
