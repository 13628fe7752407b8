"""FastKAN's Gaussian basis and its product with the coefficients — wrapper of
``csrc/kan_basis.cu``.

A FastKAN layer (``models/layers.py::FastKANLayer``) multiplies the Gaussian
basis of its LayerNorm's output ``xn`` (N, D) by its coefficients (r, D, G):
``s = basis(u(xn)) @ coeffs.reshape(r, D*G).T``. The plain version,
``kan_basis_plain``, is the layer's own code: the bf16 ``u`` promoted to a
float32 (N, D*G) basis by the float32 centres and a float32 product. The
kernel computes the same without writing the basis: it makes each chunk of
it in shared memory from ``xn``, splits each float32 value into three bf16
pieces whose sum is the value, and multiplies the pieces on the tensor
cores in float32 (see the note at the top of the source). Its output rows
are padded with zeros to a multiple of 8 (``padded``), so that the layer's
``out_linear`` reads them with cuBLAS's aligned kernels, its weight padded
alike once per version (``padded_weight``). It replaces no TPU kernel: the
JAX package leaves this einsum to XLA.

``kan_path`` picks the layer's path from what it observes: the kernel for
bf16 inputs and coefficients on a CUDA device where no gradient is wanted
(grad mode off, or nothing requires grad), and a basis of at least
``MIN_GRID`` centres; the plain path otherwise (the CPU, float32 models,
training and any autograd through the layer). ``kan_basis`` takes a CPU
tensor to the plain version and a CUDA tensor to the kernel, or raises on
what the kernel does not take. ``kan_basis.launches`` counts kernel
launches. The layer's kernel path is ``kan_fused``: the custom op
``torch.ops.detrpose_tpu_torch.kan_basis`` inside the profiler range
``SPAN``, so that ``torch.export`` keeps one op and a trace counts its
launches, then ``out_linear`` on the padded rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ...utils.graphs import device_constant, tracing
from ...utils.measure import span
from .build import load_library
from .msda import SMEM_OPTIN

KAN_ROWS = 128           # rows of a tile
KAN_COLS = 176           # columns of a tile: 513 = 3 x 176 - 15
KAN_DEPTH = 64           # K of a chunk
A_BYTES = 2 * 3 * KAN_ROWS * KAN_DEPTH * 2   # two stages of a chunk's three bf16 pieces
B_BYTES = 4 * KAN_COLS * KAN_DEPTH * 2       # four stages of the coefficients' tile
X_STAGES = 2                                  # stages of the input's tile
BARRIERS = 14 * 8                             # struct Barriers
ALIGN = 1024                                  # the 128-byte swizzle's alignment
MIN_GRID = 2                                  # one centre: a chunk's 64 inputs overflow shared memory
SPAN = "kan.fused"       # the profiler range around each launch in the layer


@device_constant
def _kan_centres(grid_size: int, device: torch.device) -> torch.Tensor:
    """(G,) float32 centres 0..G-1 of FastKAN's Gaussian basis; shared by
    every caller: read only."""
    return torch.arange(grid_size, dtype=torch.float32, device=device)


def basis_u(xn: torch.Tensor, grid_size: int) -> torch.Tensor:
    """The layer's ``u`` of its LayerNorm output, in its dtype."""
    return (torch.tanh(xn) + 1.0) * 0.5 * (grid_size - 1)


def gaussian_basis(u: torch.Tensor, grid_size: int, sigma: float) -> torch.Tensor:
    """(...) -> (..., G): the layer's basis of ``u`` over the centres 0..G-1,
    float32 for a bf16 ``u`` (the float32 centres promote it)."""
    centers = _kan_centres(grid_size, u.device)
    return torch.exp(-(((u[..., None] - centers) / (sigma + 1e-12)) ** 2))


def kan_basis_plain(xn: torch.Tensor, coeffs: torch.Tensor, sigma: float) -> torch.Tensor:
    """The layer's basis product: ``xn`` (N, D), ``coeffs`` (r, D, G) ->
    (N, r) float32 (float64 for a float64 input)."""
    D, G = coeffs.shape[1], coeffs.shape[2]
    basis = gaussian_basis(basis_u(xn, G), G, sigma)
    return basis.reshape(-1, D * G) @ coeffs.reshape(-1, D * G).to(basis.dtype).T


def u_table(grid_size: int, device: torch.device) -> torch.Tensor:
    """(65536,) bf16: the layer's ``u`` of every bf16 value, by its bits
    (entry ``i`` is u of the value whose bits are ``i``), made by the layer's
    own ops on ``device``, so that the kernel's u is the plain path's bit for
    bit (NaN for the NaN inputs)."""
    bits = torch.cat([torch.arange(0, 2 ** 15), torch.arange(-2 ** 15, 0)]).to(torch.int16)
    return basis_u(bits.to(device).view(torch.bfloat16), grid_size)


def sigma_reciprocal(sigma: float) -> float:
    """1 / (sigma + 1e-12) as a CUDA tensor's division by that scalar rounds
    it (the scalar to float32, then its float32 reciprocal), which the kernel
    multiplies by as the plain path does."""
    return float(torch.tensor(1.0) / torch.tensor(sigma + 1e-12))


def kan_path(device_type: str, dtypes: Sequence[torch.dtype], grad_enabled: bool,
             requires_grad: Sequence[bool], grid_size: int) -> str:
    """How a FastKAN layer computes its basis product: "kernel" on a CUDA
    device for bf16 ``dtypes`` (input and coefficients) when no gradient is
    wanted (grad mode off, or nothing ``requires_grad``) and the basis has
    at least ``MIN_GRID`` centres; "plain" otherwise."""
    if (device_type == "cuda" and all(d == torch.bfloat16 for d in dtypes)
            and not (grad_enabled and any(requires_grad)) and grid_size >= MIN_GRID):
        return "kernel"
    return "plain"


class KANPlan(NamedTuple):
    """A launch of the kernel."""
    xdim: int      # input columns of a chunk's tile: every input its 64 columns reach,
                   # from a multiple of 8
    smem: int      # dynamic shared memory of a block, bytes
    tiles: int     # (row tile, column tile) pairs
    grid: int      # persistent blocks, at most one an SM


def kan_plan(N: int, D: int, G: int, r: int, sms: int) -> KANPlan:
    """The launch for ``N`` rows of ``D`` inputs, ``G`` centres and ``r``
    outputs on a card of ``sms`` SMs; raises where a chunk's tiles do not
    fit a block's shared memory (fewer than ``MIN_GRID`` centres)."""
    if G < MIN_GRID:
        raise ValueError(f"kan_basis: a basis of {G} centres (at least {MIN_GRID})")
    # a chunk's columns k0 .. k0 + 63 reach inputs k0 // G .. (k0 + 63) // G
    # (ucount at most), and TMA starts the box at a multiple of 8 inputs (16
    # bytes) below; an odd multiple of 8, so that a warp's threads, a row
    # each, read a column of the tile from 8 banks and not 2
    ucount = 63 // G + 2
    xdim = 8 + 16 * -(-(ucount + 7 - 8) // 16)
    smem = (A_BYTES + B_BYTES + X_STAGES * KAN_ROWS * xdim * 2 + KAN_ROWS * ucount * 2
            + BARRIERS + ALIGN)
    if smem > SMEM_OPTIN:
        raise ValueError(f"kan_basis: {smem} bytes of shared memory for G={G}")
    tiles = -(-N // KAN_ROWS) * -(-r // KAN_COLS)
    return KANPlan(xdim, smem, tiles, min(tiles, sms))


def padded(r: int) -> int:
    """The width of the kernel's output rows for ``r`` outputs: a multiple of
    8 (16 bytes of bf16)."""
    return -(-r // 8) * 8


# each weight ``padded_weight`` padded: (its data then, its version then,
# the padded copy); the entry keeps the storage it was made from, so a weight
# at the same address is on that storage
_PADDED = WeakIdKeyDictionary()


def padded_weight(weight: torch.Tensor) -> torch.Tensor:
    """``weight`` (out, r) with zero columns up to ``padded(r)``, the width of
    the kernel's rows: made once per storage and version of the weight (a
    load, a cast or an optimiser step makes another) and kept while the
    weight lives; under a trace (``tracing``) made afresh."""
    pad = (0, padded(weight.shape[1]) - weight.shape[1])
    if tracing():
        return F.pad(weight, pad)
    version = None if weight.is_inference() else weight._version
    entry = _PADDED.get(weight)
    if entry is None or entry[0].data_ptr() != weight.data_ptr() or entry[1] != version:
        with torch.inference_mode(False), torch.no_grad():
            data = weight.detach()
            entry = _PADDED[weight] = (data, version, F.pad(data, pad))
    return entry[2]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, cols) if its rows are a multiple of 8 values wide and it
    starts at a 16-byte address, as TMA needs; else a copy padded with zeros
    to such rows."""
    rows, cols = t.shape
    width = -(-cols // 8) * 8
    if width == cols and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, width))
    out[:, :cols] = t
    return out


# xn, coeffs, the u table, out; N, D, the input's row stride, G, r, the
# coefficients' row stride; 1/sigma; the plan's xdim, smem, grid; the stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _load():
    lib, log = load_library("kan_basis.cu")
    for name in ("kan_basis_bf16", "kan_basis_f32"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, log


class KANBasis:
    """The basis product; ``launches`` counts CUDA kernel launches."""

    def __init__(self):
        self.launches = 0
        self._sms = {}
        self._u = {}       # (G, device) -> u_table, made at the first launch

    def build(self) -> str:
        """Build and load the kernel now; returns nvcc's report ("" if cached)."""
        return _load()[1]

    def __call__(self, xn: torch.Tensor, coeffs: torch.Tensor, sigma: float,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """xn (N, D) bf16; coeffs (r, D, G) bf16 -> (N, ``padded(r)``) in
        ``out_dtype`` (bf16 or float32: the kernel's float32 sums before the
        cast); the columns from r on are zeros, so that the rows start on 16
        bytes and the product that takes ``[:, :r]`` next (the layer's
        ``out_linear``) runs cuBLAS's aligned kernels."""
        dev = xn.device
        if dev.type == "cpu":
            s = kan_basis_plain(xn, coeffs, sigma).to(out_dtype)
            return torch.nn.functional.pad(s, (0, padded(s.shape[1]) - s.shape[1]))
        if dev.type != "cuda":
            raise ValueError(f"kan_basis: unsupported device {dev}")
        self._check(xn, coeffs, out_dtype)
        N, D = xn.shape
        r, _, G = coeffs.shape
        if dev.index not in self._sms:
            self._sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = kan_plan(N, D, G, r, self._sms[dev.index])
        out = torch.empty((N, padded(r)), dtype=out_dtype, device=dev)
        if out.numel() == 0:
            return out
        x = _aligned(xn)
        c = _aligned(coeffs.reshape(r, D * G))
        if (G, dev) not in self._u:
            self._u[G, dev] = u_table(G, dev)
        utab = self._u[G, dev]
        lib, _ = _load()
        fn = lib.kan_basis_bf16 if out_dtype == torch.bfloat16 else lib.kan_basis_f32
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x.data_ptr(), c.data_ptr(), utab.data_ptr(), out.data_ptr(), N, D,
                     x.shape[1], G, r, c.shape[1], sigma_reciprocal(sigma), plan.xdim,
                     plan.smem, plan.grid, stream)
        if err != 0:
            raise RuntimeError(f"kan_basis kernel launch failed: error {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(xn, coeffs, out_dtype):
        if xn.dtype != torch.bfloat16 or coeffs.dtype != torch.bfloat16:
            raise TypeError(f"kan_basis: xn and coeffs must be bfloat16, got {xn.dtype} "
                            f"and {coeffs.dtype}")
        if out_dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"kan_basis: output must be bfloat16 or float32, got {out_dtype}")
        if xn.dim() != 2 or coeffs.dim() != 3 or coeffs.shape[1] != xn.shape[1]:
            raise ValueError(f"kan_basis: xn (N, D) and coeffs (r, D, G) expected, got "
                             f"{tuple(xn.shape)} and {tuple(coeffs.shape)}")
        if coeffs.device != xn.device:
            raise ValueError(f"kan_basis: coeffs on {coeffs.device}, xn on {xn.device}")
        if not xn.is_contiguous() or not coeffs.is_contiguous():
            raise ValueError("kan_basis: xn and coeffs must be contiguous")
        # the kernel divides a column k < D*G + 64 by G as __umulhi(k, ceil(2^32 / G))
        K, G = xn.shape[1] * coeffs.shape[2], coeffs.shape[2]
        if max(xn.shape[0], coeffs.shape[0]) >= 2 ** 31 or (K + 64) * G >= 2 ** 32:
            raise ValueError(f"kan_basis: shapes {tuple(xn.shape)}, {tuple(coeffs.shape)} "
                             "past the kernel's 32-bit indices")


kan_basis = KANBasis()


@torch.library.custom_op("detrpose_tpu_torch::kan_basis", mutates_args=(),
                         schema="(Tensor xn, Tensor coeffs, float sigma) -> Tensor")
def _kan_basis_op(xn, coeffs, sigma):
    return kan_basis(xn, coeffs, sigma)


@_kan_basis_op.register_fake
def _(xn, coeffs, sigma):
    return xn.new_empty((xn.shape[0], padded(coeffs.shape[0])))


def kan_fused(xn: torch.Tensor, coeffs: torch.Tensor, sigma: float,
              linear: torch.nn.Linear) -> torch.Tensor:
    """A FastKAN layer's basis product by the kernel, inside the range
    ``SPAN``, then ``linear`` on the kernel's padded rows with its weight
    padded alike (``padded_weight``): cuBLAS's aligned kernels, where the
    odd widths 513 and 129 take a 1-element one. ``xn`` (N, D), ``coeffs``
    (r, D, G), ``linear`` r -> out; returns (N, out). No gradient flows
    through it (``kan_path``)."""
    with span(SPAN):
        s = torch.ops.detrpose_tpu_torch.kan_basis(xn, coeffs, sigma)
    return F.linear(s, padded_weight(linear.weight), linear.bias)
