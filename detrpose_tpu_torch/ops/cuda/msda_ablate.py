"""Stage ablations of the per-point MSDA kernel — wrapper of
``csrc/msda_ablate.cu``.

Port of the TPU kernel ``tools_local_msda_ablate.py::build`` (kernel :48,
``pallas_call`` :129), which times the separable MSDA kernel with stages
dropped. Each mode is a function of its own (not MSDA, except ``full``); on
the layout of ``msda_colsin.py``, per level (ix, iy, a) float32 (B, nH, P)
and the x-minor bf16 map (B, nH, H, W*dh), each gives (B, nH, P, dh) float32:

  full         the per-point bilinear sample of ``msda_colsin_plain``
  no_cexp      sum_l a_l * (two y-taps at iy_l of the row sums over x)
  stage1_only  sum_l a_l * (two y-taps at iy_l of column 0)
  io_only      sum_l ix_l on every channel; the values are not read

``msda_ablate(mode, points, values, shapes, tile)`` picks its path by device:
on a CUDA tensor it launches the mode's kernels with ``tile`` points per
block (the counterpart of the TPU's point tile TP) or raises, on a CPU tensor
it runs ``msda_ablate_plain``. ``no_cexp`` is two kernels, a row pass that
sums the maps' rows into a float32 scratch the wrapper allocates, then the
point pass; the others one. ``msda_ablate.launches`` counts kernel launches
of every mode, both of ``no_cexp``'s, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample_px
from .msda import (POINT_ARGTYPES, PointPlan, bind, check_points, launch_points, load_width,
                   point_plan)
from .msda_colsin import msda_colsin_plain, xminor_dims

MODES = ("full", "no_cexp", "stage1_only", "io_only")
TILES = (256, 1024)      # points per block, swept by tools/msda_ablate.py


def _load():
    # the point table, out, B*nH, P, nL, dh, then no_cexp's row scratch, the
    # tile, the point pass's and the row pass's channels per thread, the stream
    argtypes = POINT_ARGTYPES[:-1] + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return bind("msda_ablate.cu", tuple(f"msda_ablate_{m}" for m in MODES), argtypes)


def msda_ablate_plain(mode: str, points, values: Sequence[torch.Tensor],
                      shapes: SpatialShapes) -> torch.Tensor:
    """The plain version of ``mode`` (see the module's docstring)."""
    if mode == "full":
        return msda_colsin_plain(points, values, shapes)
    if mode not in MODES:
        raise ValueError(f"msda_ablate: unknown mode {mode!r} (one of {MODES})")
    B, nH, P = points[0][0].shape
    dh = values[0].shape[-1] // int(shapes[0][1])
    out = torch.zeros((B * nH, P, dh), dtype=torch.float32, device=points[0][0].device)
    for (ix, iy, a), v, (H, W) in zip(points, values, shapes):
        if mode == "io_only":
            out = out + ix.reshape(B * nH, P, 1)
            continue
        v = v.reshape(B * nH, H, W, dh)
        rows = v.float().sum(2) if mode == "no_cexp" else v[:, :, 0].float()
        # a one-column map sampled at x = 0 is the two y-taps of its rows
        s = bilinear_sample_px(rows, H, 1, torch.zeros_like(ix).reshape(B * nH, P),
                               iy.reshape(B * nH, P))
        out = out + s * a.reshape(B * nH, P, 1)
    return out.reshape(B, nH, P, dh)


def ablate_plan(mode: str, values: Sequence[torch.Tensor], dh: int, P: int, tile: int,
                rows_ptr: int = 0) -> tuple[PointPlan, int]:
    """The point pass's launch and the row pass's channels per thread
    (``no_cexp``, else 0); ``rows_ptr`` is the address of ``no_cexp``'s row
    scratch. Raises where a point needs more threads than a block has."""
    value_ptrs = [v.data_ptr() for v in values]
    if mode == "no_cexp":
        return point_plan(dh, 4, (rows_ptr,), P, tile), load_width(dh, 2, value_ptrs)
    return point_plan(dh, 2, () if mode == "io_only" else value_ptrs, P, tile), 0


class MSDAAblate:
    """The ablation kernels; ``launches`` counts CUDA kernel launches."""

    def __init__(self):
        self.launches = 0

    def build(self) -> str:
        """Build and load the kernels now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, mode: str, points, values: Sequence[torch.Tensor],
                 shapes: SpatialShapes, tile: int = TILES[0]) -> torch.Tensor:
        """``mode`` of ``MODES`` on the layout of ``msda_colsin`` ->
        (B, nH, P, dh) float32."""
        dev = points[0][0].device
        if dev.type == "cpu":
            return msda_ablate_plain(mode, points, values, shapes)
        if dev.type != "cuda":
            raise ValueError(f"msda_ablate: unsupported device {dev}")
        dh = self._check(mode, points, values, shapes, tile)
        B, nH, P = points[0][0].shape
        out = torch.empty((B, nH, P, dh), dtype=torch.float32, device=dev)
        if out.numel():
            rows = (torch.empty((B * nH, sum(int(h) for h, _ in shapes), dh),
                                dtype=torch.float32, device=dev)
                    if mode == "no_cexp" else None)
            plan, row_vec = ablate_plan(mode, values, dh, P, tile,
                                        0 if rows is None else rows.data_ptr())
            launch_points(f"msda_ablate {mode}", getattr(_load()[0], f"msda_ablate_{mode}"),
                          points, values, shapes, out, dh,
                          None if rows is None else rows.data_ptr(), tile, plan.vec, row_vec)
            self.launches += 2 if mode == "no_cexp" else 1
        return out

    @staticmethod
    def _check(mode, points, values, shapes, tile) -> int:
        """Raises on what the kernels do not take; returns dh."""
        if mode not in MODES:
            raise ValueError(f"msda_ablate: unknown mode {mode!r} (one of {MODES})")
        dh = values[0].shape[-1] // int(shapes[0][1]) if shapes else 0
        check_points("msda_ablate", points, values, shapes, dh, xminor_dims)
        if dh < 1:
            raise ValueError(f"msda_ablate: head width {dh}")
        if not isinstance(tile, int) or tile < 1:
            raise ValueError(f"msda_ablate: tile must be a positive int, got {tile!r}")
        try:
            ablate_plan(mode, values, dh, points[0][0].shape[-1], tile)
        except ValueError as e:
            raise ValueError(f"msda_ablate: {e}") from None
        return dh


msda_ablate = MSDAAblate()
