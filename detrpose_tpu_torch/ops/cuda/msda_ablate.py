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
on a CUDA tensor it launches the mode's kernel with ``tile`` points per block
(the counterpart of the TPU's point tile TP) or raises, on a CPU tensor it
runs ``msda_ablate_plain``. ``msda_ablate.launches`` counts kernel launches
of every mode and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample_px
from .msda import MAX_DH, MAX_SMEM, POINT_ARGTYPES, bind, check_points, launch_points
from .msda_colsin import msda_colsin_plain, xminor_dims

MODES = ("full", "no_cexp", "stage1_only", "io_only")
TILES = (256, 1024)      # points per block, swept by tools/msda_ablate.py


def _load():
    # the point table, out, B*nH, P, nL, dh, then the tile, then the stream
    argtypes = POINT_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
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
            launch_points(f"msda_ablate {mode}", getattr(_load()[0], f"msda_ablate_{mode}"),
                          points, values, shapes, out, dh, tile)
            self.launches += 1
        return out

    @staticmethod
    def _check(mode, points, values, shapes, tile) -> int:
        """Raises on what the kernels do not take; returns dh."""
        if mode not in MODES:
            raise ValueError(f"msda_ablate: unknown mode {mode!r} (one of {MODES})")
        dh = values[0].shape[-1] // int(shapes[0][1]) if shapes else 0
        check_points("msda_ablate", points, values, shapes, dh, xminor_dims)
        if not 1 <= dh <= MAX_DH:
            raise ValueError(f"msda_ablate: head width {dh} (1 to {MAX_DH})")
        if not isinstance(tile, int) or tile < 1:
            raise ValueError(f"msda_ablate: tile must be a positive int, got {tile!r}")
        if mode == "no_cexp" and 4 * dh * sum(int(h) for h, _ in shapes) > MAX_SMEM:
            raise ValueError("msda_ablate: the row sums of no_cexp exceed "
                             f"{MAX_SMEM} bytes of shared memory")
        return dh


msda_ablate = MSDAAblate()
