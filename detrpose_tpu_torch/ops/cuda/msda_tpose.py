"""MSDA per sampling point in transposed layout — wrapper of
``csrc/msda_tpose.cu``.

Port of the TPU kernel ``tools_local_msda_v2.py::build_tpose`` (kernel :152,
``pallas_call`` :199), the ``tpose`` and ``tpose_ck`` variants: the
per-point function of ``msda_colsin.py`` with the value map transposed to
(B, nH, W*dh, H) and the output to (B, nH, dh, P), points on the TPU's lanes.
``tpose_ck`` only cuts the TPU kernel's column loop into chunks of 16 to cap
VMEM; it computes the same function, so it runs this kernel too.

``msda_tpose`` picks its path by device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs ``msda_tpose_plain``.
``msda_tpose.launches`` counts kernel launches and nothing else. The kernel
splits one (image, head)'s maps by channels into groups, each held in the
shared memory of one block; ``ops/cuda/msda.py::tpose_plan`` picks the groups
for a block's shared memory budget. ``_budget`` is a hook for the tests and
the timing sweep: a smaller one forces more groups, 0 the reads from device
memory, at small shapes.
``ms_deform_attn_tpose`` is the tool's op (v2.py:193-212), with no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample_px
from ..msda_pack import level_shapes, pack_points, pack_values_tposed, unpack_output
from .msda import (MAX_LEVELS, POINT_ARGTYPES, TPOSE_BUDGET, TposePlan, bind, check_points,
                   launch_points, tpose_plan)


class _TposePlan(ctypes.Structure):
    """Mirror of ``struct TposePlan`` in csrc/msda_tpose.cu."""
    _fields_ = [(name, ctypes.c_int) for name in
                 ("groups", "chans", "staged", "threads", "blocks", "smem", "bulk")]
    _fields_ += [("offset", ctypes.c_int * MAX_LEVELS)]

    @classmethod
    def of(cls, plan: TposePlan) -> "_TposePlan":
        c = cls(plan.groups, plan.chans, int(plan.staged), plan.threads, plan.blocks,
                plan.smem, sum(1 << i for i, b in enumerate(plan.bulk) if b))
        for i, off in enumerate(plan.offset):
            c.offset[i] = off
        return c


def _load():
    # the point table, out, B*nH, P, nL, dh, the plan, the stream
    return bind("msda_tpose.cu", ("msda_tpose",),
                POINT_ARGTYPES[:-1] + [_TposePlan, POINT_ARGTYPES[-1]])


def tposed_dims(H: int, W: int, dh: int):
    """Trailing dims of one level's transposed value map."""
    return (W * dh, H)


def msda_tpose_plain(points, values: Sequence[torch.Tensor],
                     shapes: SpatialShapes) -> torch.Tensor:
    """The plain version: per level (ix, iy, a) float32 (B, nH, P) in pixel
    coordinates and the transposed map (B, nH, W*dh, H) -> (B, nH, dh, P)
    float32."""
    B, nH, P = points[0][0].shape
    out = 0.0
    for (ix, iy, a), v, (H, W) in zip(points, values, shapes):
        # (W*dh, H) -> (H*W, dh): row y*W + x holds the channels of (x, y)
        v = v.reshape(B * nH, W, -1, H).permute(0, 3, 1, 2).reshape(B * nH, H * W, -1)
        s = bilinear_sample_px(v, H, W, ix.reshape(B * nH, P), iy.reshape(B * nH, P))
        out = out + s * a.reshape(B * nH, P, 1)
    return out.reshape(B, nH, P, -1).transpose(2, 3).contiguous()


class MSDATpose:
    """The per-point MSDA, points on lanes; ``launches`` counts CUDA kernel
    launches."""

    def __init__(self):
        self.launches = 0

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, points, values: Sequence[torch.Tensor], shapes: SpatialShapes,
                 _budget: int = TPOSE_BUDGET) -> torch.Tensor:
        """``points`` per level (ix, iy, a), ``values`` per level transposed
        maps -> (B, nH, dh, P) float32."""
        dev = points[0][0].device
        if dev.type == "cpu":
            return msda_tpose_plain(points, values, shapes)
        if dev.type != "cuda":
            raise ValueError(f"msda_tpose: unsupported device {dev}")
        dh = self._check(points, values, shapes)
        B, nH, P = points[0][0].shape
        out = torch.empty((B, nH, dh, P), dtype=torch.float32, device=dev)
        if out.numel():
            plan = self.plan(values, shapes, dh, P, _budget)
            launch_points("msda_tpose", _load()[0].msda_tpose, points, values, shapes,
                          out, dh, _TposePlan.of(plan))
            self.launches += 1
        return out

    @staticmethod
    def plan(values: Sequence[torch.Tensor], shapes: SpatialShapes, dh: int, P: int,
             budget: int = TPOSE_BUDGET) -> TposePlan:
        """The kernel's launch for these maps and ``P`` points per (image, head)."""
        return tpose_plan(shapes, dh, P, [v.data_ptr() for v in values], budget)

    @staticmethod
    def _check(points, values, shapes) -> int:
        """Raises on what the kernel does not take; returns dh."""
        dh = values[0].shape[-2] // int(shapes[0][1]) if shapes else 0
        check_points("msda_tpose", points, values, shapes, dh, tposed_dims)
        if dh < 1:
            raise ValueError(f"msda_tpose: head width {dh}")
        if any(int(H) * int(W) * dh >= 2 ** 31 for H, W in shapes):
            raise ValueError("msda_tpose: one (image, head)'s map of a level past 2**31 "
                             "values, the kernel's 32-bit tap offsets")
        return dh


msda_tpose = MSDATpose()


def ms_deform_attn_tpose(value_levels: Sequence[torch.Tensor],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """The tool's op, as ``ms_deform_attn_colsin``, on the transposed layout."""
    shapes = level_shapes(value_levels)
    points = pack_points(sampling_locations, attention_weights, shapes)
    out = msda_tpose(points, pack_values_tposed(value_levels), shapes)
    return (unpack_output(out, sampling_locations.shape[4], transposed=True)
            .to(value_levels[0].dtype))
