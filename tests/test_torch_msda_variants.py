"""Kernels #3–#5 of the port, the per-point MSDA variants and ablations
(detrpose_tpu_torch/ops/cuda/msda_{colsin,tpose,ablate}.py), on the CPU.

Each plain version, and each wrapper on a CPU tensor, is held to the JAX
tool's own Pallas kernel in interpret mode. The tools
(``tools_local_msda_v2.py``, ``tools_local_msda_ablate.py``) build their
kernels inside ``main()``, so ``main()`` runs once at a tiny size
(``B 1, res 64``: levels 8/4/2) with ``pallas_call`` patched to pass
``interpret=True`` and keep the callable, and ``slope_timer`` patched to run
the timed program once; the captured callables then take seeded numpy inputs
of the same shapes. Tolerances against the TPU kernels: 1e-2 of max|ref| (the
TPU rounds its row hat, and for the ablations T*Cexp, to bf16 as MXU inputs;
the port keeps float32), and 1e-6 for ``io_only`` (the same float32 sums).
The full ops of #3 and #4 (packing and nP sum) are held to the JAX gather on
the same bf16-rounded values in float32 at 1e-5, points past every border.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import detrpose_tpu.utils.measure as jax_measure
from detrpose_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn

from detrpose_tpu_torch.ops.cuda import KERNELS
from detrpose_tpu_torch.ops.cuda.msda_ablate import (MODES, MSDAAblate, msda_ablate,
                                                     msda_ablate_plain)
from detrpose_tpu_torch.ops.cuda.msda_colsin import (MSDAColsin, ms_deform_attn_colsin,
                                                     msda_colsin, msda_colsin_plain)
from detrpose_tpu_torch.ops.cuda.msda_tpose import (MSDATpose, ms_deform_attn_tpose,
                                                    msda_tpose, msda_tpose_plain)
from detrpose_tpu_torch.ops.msda_pack import (column_planes, level_shapes, pack_points,
                                              pack_values_tposed, pack_values_xminor)
from detrpose_tpu_torch.tools import msda_ablate as ablate_tool
from detrpose_tpu_torch.tools import msda_v2

from test_torch_ops import _msda_inputs

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]

# the tools' geometry at B 1, res 64
B, NH, DH, NP, LQ = 1, 8, 32, 4, 1080
SHAPES = [(8, 8), (4, 4), (2, 2)]
P = LQ * NP


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(tool, argv):
    """Run ``tool``'s main() at ``argv`` with every pallas_call in interpret
    mode; returns the callables the pallas_calls gave, in order."""
    captured = []
    real = pl.pallas_call

    def interpret_call(*args, **kwargs):
        fn = real(*args, **dict(kwargs, interpret=True))
        captured.append(fn)
        return fn

    def timer_once(make, **_):
        make(1)()
        return 0.0, 0.0, {}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpret_call)
        mp.setattr(jax_measure, "slope_timer", timer_once)
        mp.setattr(sys, "argv", ["x"] + argv)
        mp.setenv("DETRPOSE_NO_COMPILE_CACHE", "1")
        _tool(tool).main()
    return captured


@pytest.fixture(scope="module")
def tpu_kernels():
    """The TPU kernels #3, #4 and #5 (each mode and TP) as the tools build them."""
    kernels = {v: _capture("tools_local_msda_v2", ["1", "64", v])[0]
               for v in ("colsin", "tpose")}
    ablations = _capture("tools_local_msda_ablate", ["1", "64"])
    assert len(ablations) == 8, len(ablations)
    for i, mode in enumerate(MODES):    # the tool's loop: modes, then TP 512, 1024
        kernels[f"{mode}_tp512"], kernels[f"{mode}_tp1024"] = ablations[2 * i:2 * i + 2]
    return kernels


def _points(seed, TP):
    """Seeded per-level (ix, iy, a) in the TPU tools' padded layout
    (B, nH*n_t, 1, TP), pixel coordinates reaching past every border, and the
    port's (B, nH, n_t*TP) view of the same numbers."""
    rng = np.random.default_rng(seed)
    n_t = -(-P // TP)
    jax_pts, pts = [], []
    for H, W in SHAPES:
        ix = rng.uniform(-2.0, W + 1.0, (B, NH * n_t, 1, TP)).astype(np.float32)
        iy = rng.uniform(-2.0, H + 1.0, (B, NH * n_t, 1, TP)).astype(np.float32)
        a = rng.uniform(0.0, 0.3, (B, NH * n_t, 1, TP)).astype(np.float32)
        jax_pts.append([jnp.asarray(t) for t in (ix, iy, a)])
        pts.append(tuple(torch.from_numpy(t.reshape(B, NH, n_t * TP)) for t in (ix, iy, a)))
    return jax_pts, pts


def _values(seed, transposed=False):
    """Seeded bf16 value maps, x-minor (B, nH, H, W*dh) or transposed
    (B, nH, W*dh, H): the port's tensors and the same numbers for JAX."""
    rng = np.random.default_rng(seed)
    levels = [torch.from_numpy(rng.normal(size=(B, H, W, NH, DH)).astype(np.float32))
              for H, W in SHAPES]
    vals = (pack_values_tposed if transposed else pack_values_xminor)(levels)
    return [jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in vals], vals


def _within(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def test_colsin_matches_tpu_kernel(tpu_kernels):
    jax_pts, pts = _points(0, 512)
    jax_vals, vals = _values(1)
    cols = column_planes(SHAPES, DH, "cpu")
    for c, (_, W) in zip(cols, SHAPES):   # the TPU tool's planes (v2.py:90)
        np.testing.assert_array_equal(c.numpy(), (np.arange(W * DH) // DH)[None, :])
    want = jax.jit(tpu_kernels["colsin"])(*[p[0] for p in jax_pts], *[p[1] for p in jax_pts],
                                          *[p[2] for p in jax_pts], *jax_vals,
                                          *[jnp.asarray(c.numpy()) for c in cols])
    got = msda_colsin_plain(pts, vals, SHAPES)
    _within(got, want, 1e-2)
    before = msda_colsin.launches
    torch.testing.assert_close(msda_colsin(pts, vals, cols, SHAPES), got, rtol=0, atol=0)
    assert msda_colsin.launches == before


def test_tpose_matches_tpu_kernel(tpu_kernels):
    jax_pts, pts = _points(2, 512)
    jax_vals, vals = _values(3, transposed=True)
    want = jax.jit(tpu_kernels["tpose"])(*[p[0] for p in jax_pts], *[p[1] for p in jax_pts],
                                         *[p[2] for p in jax_pts], *jax_vals)
    got = msda_tpose_plain(pts, vals, SHAPES)
    assert got.shape == (B, NH, DH, 4608)
    _within(got, want, 1e-2)
    before = msda_tpose.launches
    torch.testing.assert_close(msda_tpose(pts, vals, SHAPES), got, rtol=0, atol=0)
    assert msda_tpose.launches == before


@pytest.mark.parametrize("TP", [512, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_ablate_matches_tpu_kernel(tpu_kernels, mode, TP):
    jax_pts, pts = _points(4, TP)
    jax_vals, vals = _values(5)
    sels = [jnp.asarray(np.arange(W * DH)[:, None] % DH == np.arange(DH)[None, :],
                        jnp.bfloat16) for _, W in SHAPES]
    want = jax.jit(tpu_kernels[f"{mode}_tp{TP}"])(
        *[p[0] for p in jax_pts], *[p[1] for p in jax_pts], *[p[2] for p in jax_pts],
        *jax_vals, *sels)
    got = msda_ablate_plain(mode, pts, vals, SHAPES)
    _within(got, want, 1e-6 if mode == "io_only" else 1e-2)
    before = msda_ablate.launches
    torch.testing.assert_close(msda_ablate(mode, pts, vals, SHAPES, TP), got, rtol=0, atol=0)
    assert msda_ablate.launches == before


@pytest.mark.parametrize("nP,dh,shapes", [(4, 32, ((9, 11), (5, 6), (3, 3))),
                                          (6, 16, ((7, 5), (4, 3)))])
@pytest.mark.parametrize("op", [ms_deform_attn_colsin, ms_deform_attn_tpose])
def test_ops_match_jax_gather(op, nP, dh, shapes):
    # the same bf16-rounded values in float32 on both sides; points past every border
    vals, loc, aw = _msda_inputs(B=2, Lq=37, nH=2, nP=nP, dh=dh, shapes=shapes, seed=9,
                                 lo=-0.3, hi=1.3)
    vals = [torch.from_numpy(v).bfloat16().float() for v in vals]
    want = jax_ms_deform_attn([jnp.asarray(v.numpy()) for v in vals], jnp.asarray(loc),
                              jnp.asarray(aw))
    got = op(vals, torch.from_numpy(loc), torch.from_numpy(aw))
    assert got.dtype == torch.float32 and got.shape == (2, 37, 2 * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _packed(lo=-0.1, hi=1.1, seed=10):
    vals, loc, aw = _msda_inputs(seed=seed, lo=lo, hi=hi)
    levels = [torch.from_numpy(v) for v in vals]
    shapes = level_shapes(levels)
    return (pack_points(torch.from_numpy(loc), torch.from_numpy(aw), shapes),
            pack_values_xminor(levels), pack_values_tposed(levels), shapes)


def test_cpu_calls_count_no_launch():
    pts, xminor, tposed, shapes = _packed()
    cols = column_planes(shapes, xminor[0].shape[-1] // shapes[0][1], "cpu")
    before = {name: k.launches for name, k in KERNELS.items()}
    msda_colsin(pts, xminor, cols, shapes)
    msda_tpose(pts, tposed, shapes)
    for mode in MODES:
        msda_ablate(mode, pts, xminor, shapes)
    assert {name: k.launches for name, k in KERNELS.items()} == before


def test_out_of_range_is_zero():
    for sign in (1, -1):
        pts, xminor, tposed, shapes = _packed(lo=1.5, hi=3.0, seed=11)
        pts = [tuple(sign * t if i < 2 else t for i, t in enumerate(p)) for p in pts]
        for out in (msda_colsin_plain(pts, xminor, shapes), msda_tpose_plain(pts, tposed, shapes),
                    msda_ablate_plain("full", pts, xminor, shapes)):
            assert out.abs().max().item() == 0.0


def test_tools_check_on_cpu():
    value_levels, loc, aw = msda_v2.l_inputs(1, 64, torch.bfloat16, "cpu")
    ref = msda_v2.reference(value_levels, loc, aw)
    for variant in msda_v2.VARIANTS:     # tpose_ck at widths 8/4/2, no multiple of 16
        assert msda_v2.check(variant, value_levels, loc, aw, ref) < 1e-2
    points, values, shapes = ablate_tool.pack(1, 64, "cpu")
    errs = ablate_tool.check(points, values, shapes)
    assert sorted(errs) == sorted(f"{m}_tp{t}" for m in MODES for t in (256, 1024))
    with pytest.raises(AssertionError):   # a check that can fail
        msda_v2.check("colsin", value_levels, loc, aw, 2 * ref)


def test_tools_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        msda_v2.run(batch=1, res=64, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ablate_tool.run(batch=1, res=64, iters=1)


_CHECKS = {
    "colsin": lambda a: MSDAColsin._check(a["pts"], a["xminor"], a["cols"], a["shapes"],
                                          a["tile"]),
    "tpose": lambda a: MSDATpose._check(a["pts"], a["tposed"], a["shapes"]),
    "ablate": lambda a: MSDAAblate._check(a["mode"], a["pts"], a["xminor"], a["shapes"],
                                          a["tile"]),
}


def _break(a, bad):
    """Make one input of ``a`` wrong in the way ``bad`` names."""
    if bad == "value_dtype":
        a["xminor"] = [v.float() for v in a["xminor"]]
        a["tposed"] = [v.float() for v in a["tposed"]]
    elif bad == "loc_dtype":
        a["pts"] = [(ix.double(), iy, w) for ix, iy, w in a["pts"]]
    elif bad == "noncontig":
        a["pts"] = [(ix.transpose(0, 1).contiguous().transpose(0, 1), iy, w)
                    for ix, iy, w in a["pts"]]
    elif bad == "levels":
        a["shapes"] = a["shapes"][:1]
    elif bad == "dh":      # 257 channels on x-minor rows (one a thread, past a
        # block of #3 and #5), 0 on transposed ones
        a["xminor"] = [torch.zeros(v.shape[:3] + (v.shape[3] // 32 * 257,), dtype=torch.bfloat16)
                       for v in a["xminor"]]
        a["tposed"] = [torch.zeros(v.shape[:2] + (0, v.shape[3]), dtype=torch.bfloat16)
                       for v in a["tposed"]]
    elif bad == "cols":
        a["cols"] = [c[:, :-1] for c in a["cols"]]
    elif bad == "mode":
        a["mode"] = "stage2_only"
    elif bad == "tile":
        a["tile"] = 0


@pytest.mark.parametrize("kernel,bad", [
    (k, b) for k in _CHECKS for b in ("value_dtype", "loc_dtype", "noncontig", "levels", "dh")
] + [("colsin", "cols"), ("colsin", "tile"), ("ablate", "mode"), ("ablate", "tile")])
def test_wrapper_checks_raise(kernel, bad):
    a = dict(zip(("pts", "xminor", "tposed", "shapes"), _packed()), mode="full", tile=256)
    a["cols"] = column_planes(a["shapes"], 32, "cpu")
    assert _CHECKS[kernel](a) == 32       # the inputs made right pass
    _break(a, bad)
    with pytest.raises((TypeError, ValueError)):
        _CHECKS[kernel](a)
