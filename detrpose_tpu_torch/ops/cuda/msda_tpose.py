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
``msda_tpose.launches`` counts kernel launches and nothing else.
``ms_deform_attn_tpose`` is the tool's op (v2.py:193-212), with no gradient.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample_px
from ..msda_pack import level_shapes, pack_points, pack_values_tposed, unpack_output
from .msda import POINT_ARGTYPES, bind, check_points, launch_points


def _load():
    return bind("msda_tpose.cu", ("msda_tpose",), POINT_ARGTYPES)


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

    def __call__(self, points, values: Sequence[torch.Tensor],
                 shapes: SpatialShapes) -> torch.Tensor:
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
            launch_points("msda_tpose", _load()[0].msda_tpose, points, values, shapes,
                          out, dh)
            self.launches += 1
        return out

    @staticmethod
    def _check(points, values, shapes) -> int:
        """Raises on what the kernel does not take; returns dh."""
        dh = values[0].shape[-2] // int(shapes[0][1]) if shapes else 0
        check_points("msda_tpose", points, values, shapes, dh, tposed_dims)
        if dh < 1:
            raise ValueError(f"msda_tpose: head width {dh}")
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
