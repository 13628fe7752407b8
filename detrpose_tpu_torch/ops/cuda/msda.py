"""Multi-scale deformable attention forward — wrapper of ``csrc/msda_fwd.cu``.

Port of the TPU kernel ``detrpose_tpu/ops/pallas/msda_sep.py::_kernel``
(launched by ``ms_deform_attn_sep``, wrapped by the ``custom_vjp``
``ms_deform_attn_fast``). The CUDA kernel is the direct 4-corner gather; see
the note at the top of the source for its design and what bounds it.

``msda_forward`` picks its path by the device of the tensors it is given:
on a CUDA tensor it launches the kernel (or raises), on a CPU tensor it runs
the plain version ``ops/ms_deform_attn.py::ms_deform_attn_core``.
``msda_forward.launches`` counts kernel launches and nothing else.
``gather_plan`` is the launch plan of kernels #1 and #2 (the channels each
thread loads, threads per query, blocks), ``point_plan`` that of kernels #3
and #5 and ``tpose_plan`` that of kernel #4, plain Python so that the CPU tests can
hold them.

The model calls it as the custom op ``torch.ops.detrpose_tpu_torch.msda_fwd``,
so that ``torch.export`` keeps the kernel call in the graph (it cannot trace
into a ``ctypes`` call) and an exported program launches the kernel when it
runs. The op's gradient mirrors the JAX ``custom_vjp``: the forward is the
kernel, and the backward, inside the profiler range ``BACKWARD_RANGE`` so a
trace can give its share of a step, takes one of two paths that
``backward_path`` picks from what it observes:

- the kernel ``csrc/msda_bwd.cu`` (``msda_backward``), which writes the
  location and weight gradients and no value gradient, for a backward on
  CUDA tensors that is not itself recorded (grad mode off) and wants no
  value gradient: energy refinement's gradient in serving;
- otherwise the plain path: autograd through the plain version (as
  ``_fast_bwd`` does through the XLA path). Training of every model wants
  the value's gradient, energy training records the backward
  (``create_graph``) so that second derivatives flow as through JAX's
  gather path, and the CPU has no kernel. A recorded backward computes
  only the gradients the running backward uses.

The TPU kernel has no backward, so the backward kernel replaces none.
``msda_backward.launches`` counts its launches and ``msda_backward.plain``
the backwards on CUDA tensors that took the plain path. The wrapper takes
CUDA tensors alone; ``msda_backward_plain``, its plain twin with the
closed-form gradients written out, is the reference the tests hold the
kernel's formulas to, and no path of the program runs it.

The module also holds what the other wrappers share: ``bind`` and the level
table of kernels #1 and #2, and the per-point kernels #3–#5's table of level
pointers (``point_table``), input checks (``check_points``) and launch
(``launch_points``).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ...utils.measure import span
from ..ms_deform_attn import SpatialShapes, corner_rows, flatten_levels, ms_deform_attn_core
from .build import load_library

MAX_LEVELS = 4               # MSDA_MAX_LEVELS in the sources
BLOCK_THREADS = 256          # MSDA_THREADS in csrc/msda_gather.cuh
MAX_BLOCKS = 2 ** 31 - 1     # a grid's x dimension
MAX_GRID_YZ = 65535          # a grid's y and z dimensions
SMEM_OPTIN = 232448          # shared memory a block may opt into on sm_90 (227 KB)
SMEM_PER_SM = 233472         # shared memory of one SM on sm_90 (228 KB)
SMEM_RESERVED = 1024         # of it, what each resident block takes for itself


class _Levels(ctypes.Structure):
    """Mirror of ``struct MsdaLevels`` in the sources of csrc/."""
    _fields_ = [("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("start", ctypes.c_int * MAX_LEVELS)]


def level_table(spatial_shapes: SpatialShapes) -> _Levels:
    """Heights, widths and start rows of the levels, for a kernel launch."""
    lv = _Levels()
    start = 0
    for i, (H, W) in enumerate(spatial_shapes):
        lv.h[i], lv.w[i], lv.start[i] = int(H), int(W), start
        start += int(H) * int(W)
    return lv


def flat_hw(spatial_shapes: SpatialShapes) -> List[int]:
    """[(H, W), ...] -> [H0, W0, H1, W1, ...], the ``int[]`` a custom op takes."""
    return [int(d) for hw in spatial_shapes for d in hw]


def pairs(level_hw: Sequence[int]) -> List[Tuple[int, int]]:
    """The inverse of ``flat_hw``."""
    return [(int(level_hw[i]), int(level_hw[i + 1])) for i in range(0, len(level_hw), 2)]


class GatherPlan(NamedTuple):
    """A launch of kernel #1 or #2 (csrc/msda_gather.cuh)."""
    vec: int       # channels each thread loads at once, 16, 8, 4 or 2 bytes
    lanes: int     # threads per row (a query, or a query of one head)
    blocks: int    # of BLOCK_THREADS threads


def load_width(dh: int, itemsize: int, ptrs: Sequence[int]) -> int:
    """Channels of ``itemsize`` bytes a thread loads at once from rows of
    ``dh`` channels in maps at the addresses ``ptrs``: the widest load of at
    most 16 bytes that the head width and every address allow."""
    nbytes = next((n for n in (16, 8, 4) if n > itemsize and dh * itemsize % n == 0
                   and all(p % n == 0 for p in ptrs)), itemsize)
    return nbytes // itemsize


def gather_plan(n_heads: int, dh: int, itemsize: int, ptr: int, rows: int) -> GatherPlan:
    """The launch of ``rows`` rows of ``n_heads`` heads of ``dh`` channels of
    ``itemsize`` bytes, from a value map at address ``ptr``."""
    vec = load_width(dh, itemsize, (ptr,))
    lanes = n_heads * dh // vec
    return GatherPlan(vec, lanes, -(-rows * lanes // BLOCK_THREADS))


# The C entry points of kernels #1 and #2: value, locations, weights and
# output pointers, the level table, seven ints of shape, the plan's vec and
# blocks, the stream; they return cudaGetLastError().
_ARGTYPES = [ctypes.c_void_p] * 4 + [_Levels] + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def bind(source: str, names: Sequence[str], argtypes: Sequence = _ARGTYPES):
    """Build and load ``csrc/<source>`` and declare its MSDA entry points."""
    lib, log = load_library(source)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, log


# ---- the per-point kernels #3–#5 (csrc/msda_{colsin,tpose,ablate}.cu)

class PointPlan(NamedTuple):
    """A launch of kernel #3 (csrc/msda_colsin.cu) or kernel #5's point pass
    (csrc/msda_ablate.cu): a thread takes ``vec`` channels of one point."""
    vec: int       # channels a thread takes at once, 16, 8, 4 or 2 bytes
    lanes: int     # threads per point
    slots: int     # points of a block taken together, each by `lanes` threads
    blocks: int    # blocks along the points of one (image, head)


def point_plan(dh: int, itemsize: int, ptrs: Sequence[int], P: int, tile: int) -> PointPlan:
    """The launch of ``P`` points of one (image, head) per block row, ``tile``
    to a block, reading rows of ``dh`` channels of ``itemsize`` bytes from the
    maps at ``ptrs`` (one per level; none for a pass that reads no map);
    raises where a point needs more threads than a block has."""
    vec = load_width(dh, itemsize, ptrs)
    lanes = dh // vec
    if not 1 <= lanes <= BLOCK_THREADS:
        raise ValueError(f"a head of {dh} channels, {vec} per thread, needs {lanes} "
                         f"threads a point (1 to {BLOCK_THREADS})")
    return PointPlan(vec, lanes, BLOCK_THREADS // lanes, -(-P // tile))


TPOSE_THREADS = 512             # TPOSE_THREADS in csrc/msda_tpose.cu
TPOSE_BARRIER = 16              # the mbarrier at the start of kernel #4's shared memory
# a block's shared memory when two blocks share an SM, so that one block's
# fill overlaps the other's taps
TPOSE_BUDGET = SMEM_PER_SM // 2 - SMEM_RESERVED


class TposePlan(NamedTuple):
    """A launch of kernel #4 (csrc/msda_tpose.cu)."""
    groups: int                  # blocks per (image, head), one per channel group
    chans: int                   # channels of a group: dh / groups
    staged: bool                 # taps from shared memory, else from device memory
    threads: int                 # per block
    blocks: int                  # blocks along the points (1 when staged)
    smem: int                    # dynamic shared memory per block, bytes
    bulk: Tuple[bool, ...]       # per level: filled by bulk copies, else by the threads
    offset: Tuple[int, ...]      # per level: byte offset of its maps in shared memory


def tpose_plan(shapes: SpatialShapes, dh: int, P: int, ptrs: Sequence[int],
               budget: int = TPOSE_BUDGET) -> TposePlan:
    """Kernel #4's launch for the transposed maps of ``shapes`` (at the
    addresses ``ptrs``) and ``P`` points of one (image, head): the fewest
    channel groups (a divisor of ``dh``) whose maps fit ``budget`` bytes of
    shared memory, each group a block that holds its channels of every level
    and takes every point. Where one channel's maps do not fit, one block
    per (image, head) and point range reads the taps from device memory."""
    for chans in sorted((d for d in range(1, dh + 1) if dh % d == 0), reverse=True):
        offset, end = [], TPOSE_BARRIER
        for H, W in shapes:
            offset.append(end)
            end += -(-int(W) * chans * int(H) * 2 // 16) * 16
        if end <= budget and dh // chans <= MAX_GRID_YZ:
            break
    else:
        threads = min(TPOSE_THREADS, -(-P // 32) * 32)
        return TposePlan(1, dh, False, threads, -(-P // threads), 0,
                         (False,) * len(shapes), (0,) * len(shapes))
    # a column's run of a group is chans * H values: one bulk copy where it
    # and the map's address are multiples of 16 bytes
    bulk = tuple(p % 16 == 0 and chans * int(H) * 2 % 16 == 0
                 for p, (H, _) in zip(ptrs, shapes))
    threads = min(TPOSE_THREADS, -(-P // 32) * 32)
    return TposePlan(dh // chans, chans, True, threads, 1, end, bulk, tuple(offset))


class _PointLevels(ctypes.Structure):
    """Mirror of ``struct PointLevels`` in the per-point sources: per level
    the (ix, iy, a) point arrays, the value map, its height and width."""
    _fields_ = [("ix", ctypes.c_void_p * MAX_LEVELS),
                ("iy", ctypes.c_void_p * MAX_LEVELS),
                ("a", ctypes.c_void_p * MAX_LEVELS),
                ("v", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS)]


# their C entry points: the point table, the output pointer, four ints
# (B*nH, P, nL, dh), the stream
POINT_ARGTYPES = [_PointLevels, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def point_table(points, values, shapes: SpatialShapes) -> _PointLevels:
    """Device pointers of the per-level (ix, iy, a) and value maps, and the
    levels' sizes, for a launch of a per-point kernel."""
    lv = _PointLevels()
    for i, ((ix, iy, a), v, (H, W)) in enumerate(zip(points, values, shapes)):
        lv.ix[i], lv.iy[i], lv.a[i] = ix.data_ptr(), iy.data_ptr(), a.data_ptr()
        lv.v[i] = v.data_ptr()
        lv.h[i], lv.w[i] = int(H), int(W)
    return lv


def check_points(name: str, points, values, shapes: SpatialShapes, dh: int,
                 value_dims) -> None:
    """Checks of a per-point kernel's inputs; raises on what it does not take.

    ``points``: per level (ix, iy, a), float32 (B, nH, P), contiguous;
    ``values``: per level bf16 (B, nH) + ``value_dims(H, W, dh)``,
    contiguous; all on one device."""
    nL = len(shapes)
    if not 1 <= nL <= MAX_LEVELS or len(points) != nL or len(values) != nL:
        raise ValueError(f"{name}: {len(points)} point levels and {len(values)} value "
                         f"levels for {nL} level shapes (1 to {MAX_LEVELS})")
    if points[0][0].dim() != 3:
        raise ValueError(f"{name}: points must be (B, nH, P), got "
                         f"{tuple(points[0][0].shape)}")
    B, nH, P = points[0][0].shape
    dev = points[0][0].device
    for lvl, ((ix, iy, a), v, (H, W)) in enumerate(zip(points, values, shapes)):
        for t in (ix, iy, a):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, nH, P):
                raise ValueError(f"{name}: level {lvl} points must be float32 (B, nH, P) "
                                 f"like level 0's {(B, nH, P)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        if v.dtype != torch.bfloat16:
            raise TypeError(f"{name}: values must be bfloat16, got {v.dtype}")
        want = (B, nH) + tuple(value_dims(int(H), int(W), dh))
        if tuple(v.shape) != want:
            raise ValueError(f"{name}: level {lvl} values {tuple(v.shape)}, expected {want}")
        for t in (ix, iy, a, v):
            if t.device != dev:
                raise ValueError(f"{name}: inputs on {t.device} and {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: inputs must be contiguous")
    if B * nH > MAX_GRID_YZ:
        raise ValueError(f"{name}: grid of {B * nH} (image, head) pairs too large")


def launch_points(name: str, fn, points, values, shapes: SpatialShapes,
                  out: torch.Tensor, dh: int, *extra: int) -> None:
    """Launch a per-point kernel on the current stream of ``out``'s device;
    raises if the launch failed."""
    B, nH, P = points[0][0].shape
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(point_table(points, values, shapes), out.data_ptr(), B * nH, P,
                 len(shapes), dh, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _load():
    return bind("msda_fwd.cu", ("msda_fwd_f32", "msda_fwd_bf16"))


class MSDAForward:
    """The MSDA forward; ``launches`` counts CUDA kernel launches."""

    def __init__(self):
        self.launches = 0

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, value: torch.Tensor, spatial_shapes: SpatialShapes,
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        """value (B, S, nH*dh); locations (B, Lq, nH, nL, nP, 2) float32;
        weights (B, Lq, nH, nL, nP) float32 -> (B, Lq, nH*dh) in value's dtype."""
        dev = value.device
        if dev.type == "cpu":
            return ms_deform_attn_core(value, spatial_shapes, sampling_locations,
                                       attention_weights)
        if dev.type != "cuda":
            raise ValueError(f"msda_forward: unsupported device {dev}")
        self._check(value, spatial_shapes, sampling_locations, attention_weights)
        B, Lq, nH, nL, nP, _ = sampling_locations.shape
        S, C = value.shape[1], value.shape[2]
        out = torch.empty((B, Lq, C), dtype=value.dtype, device=dev)
        if out.numel() == 0:
            return out
        plan = gather_plan(nH, C // nH, value.element_size(), value.data_ptr(), B * Lq)
        lib, _ = _load()
        fn = lib.msda_fwd_bf16 if value.dtype == torch.bfloat16 else lib.msda_fwd_f32
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(value.data_ptr(), sampling_locations.data_ptr(),
                     attention_weights.data_ptr(), out.data_ptr(),
                     level_table(spatial_shapes), B, S, Lq, nH, nL, nP, C // nH, plan.vec,
                     plan.blocks, stream)
        if err != 0:
            raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(value, spatial_shapes, loc, aw):
        check_inputs("msda_forward", value, spatial_shapes, loc, aw)
        B, Lq, nH = loc.shape[:3]
        C = value.shape[2]
        if gather_plan(nH, C // nH, value.element_size(), value.data_ptr(),
                       B * Lq).blocks > MAX_BLOCKS:
            raise ValueError(f"msda_forward: {B * Lq} queries of {C} channels need too "
                             "large a grid")


def check_inputs(name: str, value, spatial_shapes, loc, aw) -> None:
    """Checks of the op's inputs for a kernel launch; raises on what kernels
    #1 and its backward do not take."""
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: value must be float32 or bfloat16, got {value.dtype}")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError(f"{name}: locations and weights must be float32, "
                        f"got {loc.dtype} and {aw.dtype}")
    for what, t in (("value", value), ("locations", loc), ("weights", aw)):
        if t.device != value.device:
            raise ValueError(f"{name}: {what} on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if value.dim() != 3 or loc.dim() != 6 or loc.shape[-1] != 2:
        raise ValueError(f"{name}: bad shapes value {tuple(value.shape)}, "
                         f"locations {tuple(loc.shape)}")
    B, Lq, nH, nL, nP, _ = loc.shape
    if tuple(aw.shape) != (B, Lq, nH, nL, nP):
        raise ValueError(f"{name}: weights {tuple(aw.shape)} do not match "
                         f"locations {tuple(loc.shape)}")
    if len(spatial_shapes) != nL or not 1 <= nL <= MAX_LEVELS:
        raise ValueError(f"{name}: {len(spatial_shapes)} spatial shapes for "
                         f"{nL} levels (at most {MAX_LEVELS})")
    S = sum(int(h) * int(w) for h, w in spatial_shapes)
    C = value.shape[2]
    if value.shape[0] != B or value.shape[1] != S or C % nH:
        raise ValueError(f"{name}: value {tuple(value.shape)} does not match "
                         f"B={B}, S={S}, nH={nH}")


msda_forward = MSDAForward()


# ---- the op's backward for the locations and weights (csrc/msda_bwd.cu)

class BackwardPlan(NamedTuple):
    """A launch of the backward kernel (csrc/msda_bwd.cu)."""
    vec: int       # channels each thread loads at once, 16, 8, 4 or 2 bytes
    lanes: int     # threads per (query, head): a power of two, at most 32
    chunks: int    # the channel vectors each thread takes, one after another
    blocks: int    # of BLOCK_THREADS threads


def backward_plan(dh: int, itemsize: int, ptrs: Sequence[int], heads: int) -> BackwardPlan:
    """The launch for ``heads`` (query, head) pairs of ``dh`` channels of
    ``itemsize`` bytes, from maps at the addresses ``ptrs`` (the value map
    and the output's gradient): the head's channel vectors on a power of two
    of lanes, at most a warp, so that a head's lanes add up their sums by
    shuffles within one warp."""
    vec = load_width(dh, itemsize, ptrs)
    need = dh // vec
    lanes = min(32, 1 << (need - 1).bit_length())
    return BackwardPlan(vec, lanes, -(-need // lanes), -(-heads * lanes // BLOCK_THREADS))


def msda_backward_plain(value: torch.Tensor, spatial_shapes: SpatialShapes,
                        sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                        grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's plain twin: the gradients of
    ``ms_deform_attn_core`` for its locations and weights at the output's
    gradient ``grad_out``, by their closed forms (csrc/msda_bwd.cu's note)
    and not by autograd; the floors held constant, each corner's terms
    multiplied by whether it lies in the map. Computed in float32, or
    float64 where an input is; returned in the locations' and weights'
    dtypes."""
    B, Lq, nH, nL, nP, _ = sampling_locations.shape
    C = value.shape[-1]
    dh = C // nH
    acc = torch.promote_types(torch.promote_types(value.dtype, sampling_locations.dtype),
                              torch.float32)
    loc = sampling_locations.to(acc)
    aw = attention_weights.to(acc)
    # (B, Lq, C) -> (B*nH, Lq*nP, dh): each query's gradient at its points
    go = grad_out.to(acc).reshape(B, Lq, nH, 1, dh).permute(0, 2, 1, 3, 4)
    go = go.expand(B, nH, Lq, nP, dh).reshape(B * nH, Lq * nP, dh)
    grads_loc, grads_aw = [], []
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W].reshape(B, H * W, nH, dh)
        v = v.permute(0, 2, 1, 3).reshape(B * nH, H * W, dh)
        start += H * W
        lx, ly, a = (t.permute(0, 2, 1, 3).reshape(B * nH, Lq * nP)
                     for t in (loc[:, :, :, lvl, :, 0], loc[:, :, :, lvl, :, 1],
                               aw[:, :, :, lvl]))
        ix = lx * W - 0.5
        iy = ly * H - 0.5
        x0 = torch.floor(ix)
        y0 = torch.floor(iy)
        x1 = x0 + 1.0
        y1 = y0 + 1.0
        m = []   # per corner: sum over channels of grad_out * row, * whether in the map
        for xc, yc in ((x0, y0), (x0, y1), (x1, y0), (x1, y1)):
            g, valid = corner_rows(v, H, W, xc, yc)
            m.append((g.to(acc) * go).sum(-1) * valid)
        fx0, fx1, fy0, fy1 = x1 - ix, ix - x0, y1 - iy, iy - y0
        ga = fx0 * fy0 * m[0] + fx0 * fy1 * m[1] + fx1 * fy0 * m[2] + fx1 * fy1 * m[3]
        gx = W * (a * (fy0 * (m[2] - m[0]) + fy1 * (m[3] - m[1])))
        gy = H * (a * (fx0 * (m[1] - m[0]) + fx1 * (m[3] - m[2])))
        grads_loc.append(torch.stack([gx, gy], -1).reshape(B, nH, Lq, nP, 2))
        grads_aw.append(ga.reshape(B, nH, Lq, nP))
    grad_loc = torch.stack(grads_loc, 3).permute(0, 2, 1, 3, 4, 5)
    grad_aw = torch.stack(grads_aw, 3).permute(0, 2, 1, 3, 4)
    return (grad_loc.to(sampling_locations.dtype).contiguous(),
            grad_aw.to(attention_weights.dtype).contiguous())


def _load_backward():
    return bind("msda_bwd.cu", ("msda_bwd_f32", "msda_bwd_bf16"),
                [ctypes.c_void_p] * 6 + [_Levels] + [ctypes.c_int] * 10 + [ctypes.c_void_p])


class MSDABackward:
    """The op's backward for the locations and weights; ``launches`` counts
    CUDA kernel launches, ``plain`` the op's backwards on CUDA tensors that
    took the plain path (``_backward``)."""

    def __init__(self):
        self.launches = 0
        self.plain = 0

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load_backward()[1]

    def __call__(self, value: torch.Tensor, spatial_shapes: SpatialShapes,
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 grad_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """value (B, S, nH*dh); locations (B, Lq, nH, nL, nP, 2) float32;
        weights (B, Lq, nH, nL, nP) float32; grad_out (B, Lq, nH*dh) in
        value's dtype -> (the locations' gradient, the weights'), float32."""
        dev = value.device
        if dev.type != "cuda":
            raise ValueError(f"msda_backward: unsupported device {dev}")
        check_inputs("msda_backward", value, spatial_shapes, sampling_locations,
                     attention_weights)
        B, Lq, nH, nL, nP, _ = sampling_locations.shape
        S, C = value.shape[1], value.shape[2]
        if grad_out.dtype != value.dtype or tuple(grad_out.shape) != (B, Lq, C):
            raise ValueError(f"msda_backward: grad_out must be {value.dtype} {(B, Lq, C)}, "
                             f"got {grad_out.dtype} {tuple(grad_out.shape)}")
        if grad_out.device != dev or not grad_out.is_contiguous():
            raise ValueError(f"msda_backward: grad_out must be contiguous on {dev}")
        plan = backward_plan(C // nH, value.element_size(),
                             (value.data_ptr(), grad_out.data_ptr()), B * Lq * nH)
        if plan.blocks > MAX_BLOCKS:
            raise ValueError(f"msda_backward: {B * Lq} queries of {C} channels need too "
                             "large a grid")
        grad_loc = torch.empty(sampling_locations.shape, dtype=torch.float32, device=dev)
        grad_aw = torch.empty(attention_weights.shape, dtype=torch.float32, device=dev)
        if grad_aw.numel() == 0:
            return grad_loc, grad_aw
        lib, _ = _load_backward()
        fn = lib.msda_bwd_bf16 if value.dtype == torch.bfloat16 else lib.msda_bwd_f32
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(value.data_ptr(), sampling_locations.data_ptr(),
                     attention_weights.data_ptr(), grad_out.data_ptr(), grad_loc.data_ptr(),
                     grad_aw.data_ptr(), level_table(spatial_shapes), B, S, Lq, nH, nL, nP,
                     C // nH, plan.vec, plan.lanes, plan.blocks, stream)
        if err != 0:
            raise RuntimeError(f"msda_bwd kernel launch failed: CUDA error {err}")
        self.launches += 1
        return grad_loc, grad_aw


msda_backward = MSDABackward()


def backward_path(device_type: str, grad_enabled: bool,
                  needs_input_grad: Sequence[bool]) -> str:
    """How the op's backward runs, from what it observes: "kernel"
    (``msda_backward``) on a CUDA device, with grad mode off (the backward is
    not itself recorded), for the locations' or the weights' gradient and
    not the value's (``needs_input_grad``: value, locations, weights);
    "plain" (autograd through ``ms_deform_attn_core``) otherwise."""
    value, loc, aw = needs_input_grad
    if device_type == "cuda" and not grad_enabled and not value and (loc or aw):
        return "kernel"
    return "plain"


@torch.library.custom_op(
    "detrpose_tpu_torch::msda_fwd", mutates_args=(),
    schema="(Tensor value, int[] level_hw, Tensor loc, Tensor aw) -> Tensor")
def _msda_fwd_op(value, level_hw, loc, aw):
    return msda_forward(value, pairs(level_hw), loc, aw)


@_msda_fwd_op.register_fake
def _(value, level_hw, loc, aw):
    return value.new_empty((loc.shape[0], loc.shape[1], value.shape[2]))


def _setup_context(ctx, inputs, output):
    value, level_hw, loc, aw = inputs
    ctx.save_for_backward(value, loc, aw)
    ctx.level_hw = level_hw


BACKWARD_RANGE = "msda_fwd_backward"   # the profiler range of the op's backward


def _backward(ctx, grad_out):
    # All of the backward's device work is launched inside BACKWARD_RANGE,
    # on the thread autograd runs it on (its own device thread on the card):
    # the benchmark's backward roofline (h100_bench/bounds_msda_bwd.py) reads
    # the work of one such range, the kernel's or the plain path's.
    value, loc, aw = ctx.saved_tensors
    need = (ctx.needs_input_grad[0], ctx.needs_input_grad[2], ctx.needs_input_grad[3])
    if backward_path(value.device.type, torch.is_grad_enabled(), need) == "kernel":
        with span(BACKWARD_RANGE):
            gl, ga = msda_backward(value, pairs(ctx.level_hw), loc, aw, grad_out.contiguous())
        return None, None, gl if need[1] else None, ga if need[2] else None
    if value.is_cuda:
        msda_backward.plain += 1
    if torch.is_grad_enabled():
        # a backward that is itself differentiated (create_graph=True): the
        # plain version's gradient on the saved inputs, recorded, so that a
        # second derivative flows to value, loc and aw as through JAX's
        # gather path. An input whose gradient the running backward does not
        # use is left out (energy refinement's inner gradient wants none for
        # the value): its recorded graph would be held for nothing
        need = tuple(n and (t.grad_fn is None or torch._C._will_engine_execute_node(t.grad_fn))
                     for t, n in zip((value, loc, aw), need))
        wanted = [t for t, n in zip((value, loc, aw), need) if n]
        with span(BACKWARD_RANGE):
            out = ms_deform_attn_core(value, pairs(ctx.level_hw), loc, aw)
            grads = iter(torch.autograd.grad(out, wanted, grad_out, create_graph=True))
        gv, gl, ga = (next(grads) if n else None for n in need)
        return gv, None, gl, ga
    inputs = [t.detach().requires_grad_(n) for t, n in zip((value, loc, aw), need)]
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad(), span(BACKWARD_RANGE):
            out = ms_deform_attn_core(inputs[0], pairs(ctx.level_hw), inputs[1], inputs[2])
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
    gv, gl, ga = (next(grads) if t.requires_grad else None for t in inputs)
    return gv, None, gl, ga


_msda_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def ms_deform_attn_fast_flat(value: torch.Tensor, spatial_shapes: SpatialShapes,
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor) -> torch.Tensor:
    """Kernel forward, plain-version gradients, on the flattened pyramid."""
    return torch.ops.detrpose_tpu_torch.msda_fwd(
        value.contiguous(), flat_hw(spatial_shapes), sampling_locations.contiguous(),
        attention_weights.contiguous())


def ms_deform_attn_fast(value_levels: Sequence[torch.Tensor],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """The JAX ``ms_deform_attn_fast`` signature: per-level (B, H, W, nH, dh)
    values, float32 locations and weights -> (B, Lq, nH*dh)."""
    value, shapes = flatten_levels(value_levels)
    return ms_deform_attn_fast_flat(value, shapes, sampling_locations,
                                    attention_weights)
