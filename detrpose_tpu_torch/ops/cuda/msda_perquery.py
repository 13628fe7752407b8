"""Per-query multi-scale deformable attention forward — wrapper of
``csrc/msda_perquery.cu``.

Port of the TPU kernel ``detrpose_tpu/ops/pallas/msda.py::_msda_kernel``
(launched by ``ms_deform_attn_pallas``, the ``msda_backend="pallas"`` of the
model config). It keeps that kernel's per-head packing: the value map as
``(B, nH, S, dh)``, locations ``(B, nH, Lq, nL*nP*2)`` and weights
``(B, nH, Lq, nL*nP)``, output ``(B, nH, Lq, dh)``; the TPU's padding of S to
8 rows and of Lq to 128 queries is Mosaic's alignment rule and is dropped
(the kernel masks its ragged query tile).

``msda_perquery`` takes the packed layout and picks its path by device: on a
CUDA tensor it launches the kernel (or raises), on a CPU tensor it runs the
plain version ``msda_perquery_plain`` on the same packed layout.
``msda_perquery.launches`` counts kernel launches and nothing else. The
model reaches it through the custom op
``torch.ops.detrpose_tpu_torch.msda_perquery`` (so ``torch.export`` keeps the
call) via ``ms_deform_attn_pallas``, which packs and unpacks around it. The
op has no gradient, as the TPU kernel has none.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ms_deform_attn import SpatialShapes, bilinear_sample
from .msda import MAX_BLOCKS, MAX_LEVELS, bind, flat_hw, gather_plan, level_table, pairs

MAX_DH = 64          # the widest head the op takes


def _load():
    return bind("msda_perquery.cu", ("msda_perquery_f32", "msda_perquery_bf16"))


def pack_value(value: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The flattened pyramid (B, S, nH*dh) -> (B, nH, S, dh), contiguous."""
    B, S, C = value.shape
    return value.reshape(B, S, n_heads, C // n_heads).transpose(1, 2).contiguous()


def pack_points(sampling_locations: torch.Tensor, attention_weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Locations (B, Lq, nH, nL, nP, 2) and weights (B, Lq, nH, nL, nP) ->
    float32 (B, nH, Lq, nL*nP*2) and (B, nH, Lq, nL*nP), contiguous
    (msda.py:128-130 of the JAX package)."""
    B, Lq, nH, nL, nP, _ = sampling_locations.shape
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)
    aw = attention_weights.float().permute(0, 2, 1, 3, 4)
    return (loc.reshape(B, nH, Lq, nL * nP * 2).contiguous(),
            aw.reshape(B, nH, Lq, nL * nP).contiguous())


def msda_perquery_plain(value: torch.Tensor, spatial_shapes: SpatialShapes,
                        loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """The plain version on the packed layout.

    value (B, nH, S, dh); loc (B, nH, Lq, nL*nP*2) and aw (B, nH, Lq, nL*nP),
    level-major -> (B, nH, Lq, dh) in value's dtype, summed in float32.
    """
    B, nH, _, dh = value.shape
    Lq, nL = loc.shape[2], len(spatial_shapes)
    nP = aw.shape[-1] // nL
    v = value.reshape(B * nH, -1, dh)
    loc = loc.float().reshape(B * nH, Lq, nL, nP, 2)
    aw = aw.float().reshape(B * nH, Lq, nL, nP)
    out = value.new_zeros((B * nH, Lq, dh), dtype=torch.float32)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        sampled = bilinear_sample(v[:, start:start + H * W], H, W,
                                  loc[:, :, lvl, :, 0].reshape(B * nH, Lq * nP),
                                  loc[:, :, lvl, :, 1].reshape(B * nH, Lq * nP))
        sampled = sampled * aw[:, :, lvl].reshape(B * nH, Lq * nP)[..., None]
        out = out + sampled.reshape(B * nH, Lq, nP, dh).sum(dim=2)
        start += H * W
    return out.reshape(B, nH, Lq, dh).to(value.dtype)


class MSDAPerQuery:
    """The per-query MSDA forward; ``launches`` counts CUDA kernel launches."""

    def __init__(self):
        self.launches = 0

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, value: torch.Tensor, spatial_shapes: SpatialShapes,
                 loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
        """The packed layout of ``msda_perquery_plain``."""
        dev = value.device
        if dev.type == "cpu":
            return msda_perquery_plain(value, spatial_shapes, loc, aw)
        if dev.type != "cuda":
            raise ValueError(f"msda_perquery: unsupported device {dev}")
        self._check(value, spatial_shapes, loc, aw)
        B, nH, S, dh = value.shape
        Lq, nL = loc.shape[2], len(spatial_shapes)
        nP = aw.shape[-1] // nL
        out = torch.empty((B, nH, Lq, dh), dtype=value.dtype, device=dev)
        if out.numel() == 0:
            return out
        plan = gather_plan(1, dh, value.element_size(), value.data_ptr(), B * nH * Lq)
        lib, _ = _load()
        fn = lib.msda_perquery_bf16 if value.dtype == torch.bfloat16 else lib.msda_perquery_f32
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
                     level_table(spatial_shapes), B, nH, S, Lq, nL, nP, dh, plan.vec,
                     plan.blocks, stream)
        if err != 0:
            raise RuntimeError(f"msda_perquery kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(value, spatial_shapes, loc, aw):
        if value.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"msda_perquery: value must be float32 or bfloat16, "
                            f"got {value.dtype}")
        if loc.dtype != torch.float32 or aw.dtype != torch.float32:
            raise TypeError("msda_perquery: locations and weights must be float32, "
                            f"got {loc.dtype} and {aw.dtype}")
        for name, t in (("value", value), ("locations", loc), ("weights", aw)):
            if t.device != value.device:
                raise ValueError(f"msda_perquery: {name} on {t.device}, "
                                 f"value on {value.device}")
            if not t.is_contiguous():
                raise ValueError(f"msda_perquery: {name} must be contiguous")
            if t.dim() != 4:
                raise ValueError(f"msda_perquery: {name} must have 4 dims, "
                                 f"got {tuple(t.shape)}")
        B, nH, S, dh = value.shape
        nL = len(spatial_shapes)
        if not 1 <= nL <= MAX_LEVELS:
            raise ValueError(f"msda_perquery: {nL} levels (at most {MAX_LEVELS})")
        if S != sum(int(h) * int(w) for h, w in spatial_shapes):
            raise ValueError(f"msda_perquery: value has {S} rows, the levels "
                             f"{list(spatial_shapes)} have another count")
        if not 1 <= dh <= MAX_DH:
            raise ValueError(f"msda_perquery: head width {dh} (at most {MAX_DH})")
        n_pts = aw.shape[-1]
        # any point count: the generic point loop of csrc/msda_gather.cuh
        # takes what the 4- and 6-point instantiations do not (the grid
        # branch's 3 x 16 a query)
        if (tuple(aw.shape[:2]) != (B, nH) or n_pts % nL or n_pts < 1
                or tuple(loc.shape) != tuple(aw.shape[:3]) + (2 * n_pts,)):
            raise ValueError(f"msda_perquery: locations {tuple(loc.shape)} and weights "
                             f"{tuple(aw.shape)} do not fit value {tuple(value.shape)} "
                             f"and {nL} levels")
        Lq = loc.shape[2]
        if gather_plan(1, dh, value.element_size(), value.data_ptr(),
                       B * nH * Lq).blocks > MAX_BLOCKS:
            raise ValueError(f"msda_perquery: {B * nH * Lq} (image, head, query) rows "
                             "need too large a grid")


msda_perquery = MSDAPerQuery()


@torch.library.custom_op(
    "detrpose_tpu_torch::msda_perquery", mutates_args=(),
    schema="(Tensor value, int[] level_hw, Tensor loc, Tensor aw) -> Tensor")
def _msda_perquery_op(value, level_hw, loc, aw):
    return msda_perquery(value, pairs(level_hw), loc, aw)


@_msda_perquery_op.register_fake
def _(value, level_hw, loc, aw):
    return value.new_empty(tuple(value.shape[:2]) + (loc.shape[2], value.shape[3]))


def _run_packed(value: torch.Tensor, spatial_shapes: SpatialShapes,
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor) -> torch.Tensor:
    """Packed value (B, nH, S, dh) -> (B, Lq, nH*dh): packs the locations and
    weights, runs the op and unpacks its output (msda.py:155-156)."""
    B, Lq, nH = sampling_locations.shape[:3]
    out = torch.ops.detrpose_tpu_torch.msda_perquery(
        value, flat_hw(spatial_shapes), *pack_points(sampling_locations, attention_weights))
    return out.transpose(1, 2).reshape(B, Lq, nH * value.shape[-1])


def ms_deform_attn_pallas_flat(value: torch.Tensor, spatial_shapes: SpatialShapes,
                               sampling_locations: torch.Tensor,
                               attention_weights: torch.Tensor) -> torch.Tensor:
    """The kernel on the flattened pyramid ``(B, S, nH*dh)`` the model builds
    -> (B, Lq, nH*dh)."""
    return _run_packed(pack_value(value, sampling_locations.shape[2]), spatial_shapes,
                       sampling_locations, attention_weights)


def ms_deform_attn_pallas(value_levels: Sequence[torch.Tensor],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """The JAX ``ms_deform_attn_pallas`` signature: per-level (B, H, W, nH, dh)
    values, locations (B, Lq, nH, nL, nP, 2) and weights (B, Lq, nH, nL, nP)
    -> (B, Lq, nH*dh)."""
    B, _, _, nH, dh = value_levels[0].shape
    shapes = [(int(v.shape[1]), int(v.shape[2])) for v in value_levels]
    packed = torch.cat([v.reshape(B, -1, nH, dh).transpose(1, 2) for v in value_levels],
                       dim=2)
    return _run_packed(packed, shapes, sampling_locations, attention_weights)
