"""The port's ops (detrpose_tpu_torch/ops) against their JAX counterparts.

Inputs come from numpy.random.default_rng and go to both sides. Tolerances:
float32 ops agree to 1e-5 (relative, with a 1e-6 absolute floor for values
near 0); the bf16 MSDA comparisons against the TPU kernel's interpret mode
use its own contract, 1% of max|ref| (tests/test_msda_sep.py).
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.ops import fdr as jfdr
from detrpose_tpu.ops import grid_sample as jgs
from detrpose_tpu.ops import misc as jmisc
from detrpose_tpu.ops.ms_deform_attn import ms_deform_attn as jax_ms_deform_attn
from detrpose_tpu.ops import pos_embed as jpos
from detrpose_tpu.ops.pallas import msda_sep

from detrpose_tpu_torch.ops import fdr, grid_sample, misc, pos_embed
from detrpose_tpu_torch.ops.cuda.msda import (MSDAForward, ms_deform_attn_fast,
                                              msda_forward)
from detrpose_tpu_torch.ops.ms_deform_attn import (flatten_levels, ms_deform_attn,
                                                   ms_deform_attn_core)

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_inverse_sigmoid():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (4, 33)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 1e-4, 1 - 1e-4]
    _close(misc.inverse_sigmoid(torch.from_numpy(x)), jmisc.inverse_sigmoid(jnp.asarray(x)))


def test_sine_embedding_2d():
    pos = np.random.default_rng(1).uniform(0, 1, (2, 5, 17, 2)).astype(np.float32)
    _close(pos_embed.sine_embedding_2d(torch.from_numpy(pos), 256),
           jpos.sine_embedding_2d(jnp.asarray(pos), 256))


@pytest.mark.parametrize("w,h,dim", [(20, 20, 128), (5, 4, 64)])
def test_sine_hw_position_embedding(w, h, dim):
    _close(pos_embed.sine_hw_position_embedding(w, h, dim),
           jpos.sine_hw_position_embedding(w, h, dim))


def test_fdr():
    w = fdr.weighting_function(32, 0.5, 4.0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jfdr.weighting_function(32, 0.5, 4.0)))
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (2, 7, 17, 66)).astype(np.float32)
    got = fdr.integral(torch.from_numpy(x), w)
    want = jfdr.integral(jnp.asarray(x), jnp.asarray(w.numpy()))
    _close(got, want)
    p = rng.uniform(0, 1, (2, 7, 17, 2)).astype(np.float32)
    _close(fdr.distance2pose(torch.from_numpy(p), got, 4.0),
           jfdr.distance2pose(jnp.asarray(p), want, 4.0))


def test_integral_softmax_in_f32():
    # bf16 logits: the expectation is taken in float32, then cast back
    w = fdr.weighting_function(32, 0.5, 4.0)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 3, (3, 66)).astype(np.float32))
    got = fdr.integral(x.bfloat16(), w)
    assert got.dtype == torch.bfloat16
    want = fdr.integral(x.bfloat16().float(), w)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(9, 11), (20, 20)])  # one-hot and gather paths of JAX
def test_bilinear_grid_sample(hw):
    rng = np.random.default_rng(4)
    H, W = hw
    feat = rng.normal(size=(2, H, W, 8)).astype(np.float32)
    # reaching past the border exercises the per-corner zero padding
    grid = rng.uniform(-1.3, 1.3, (2, 6, 17, 2)).astype(np.float32)
    # unit-scale values; the corner weights are formed in another order than
    # in F.grid_sample, so the floor is 1e-5 absolute
    _close(grid_sample.bilinear_grid_sample(torch.from_numpy(feat), torch.from_numpy(grid)),
           jgs.bilinear_grid_sample(jnp.asarray(feat), jnp.asarray(grid)), atol=1e-5)


# ---------------------------------------------------------------- MSDA


def _msda_inputs(B=2, Lq=50, nH=8, nP=4, dh=32, shapes=((16, 16), (8, 8), (4, 4)),
                 seed=0, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    nL = len(shapes)
    vals = [rng.normal(size=(B, H, W, nH, dh)).astype(np.float32) for H, W in shapes]
    loc = rng.uniform(lo, hi, (B, Lq, nH, nL, nP, 2)).astype(np.float32)
    aw = rng.random((B, Lq, nH, nL, nP)).astype(np.float32)
    aw /= aw.sum(axis=(-1, -2), keepdims=True)
    return vals, loc, aw


_T = torch.from_numpy

MSDA_CASES = [  # (Lq, level shapes, nP, dh)
    (50, ((16, 16), (8, 8), (4, 4)), 4, 32),
    (128, ((16, 16), (8, 8), (4, 4)), 4, 32),
    (135, ((16, 16), (8, 8), (4, 4)), 4, 32),   # 540 points: two 512-point tiles
    (50, ((12, 12), (6, 6)), 6, 16),            # N: 2 levels, 6 points, dh 16
    (135, ((12, 12), (6, 6)), 6, 16),
    (50, ((16, 16), (8, 8), (4, 4)), 4, 48),    # X: dh 48
]


@pytest.mark.parametrize("Lq,shapes,nP,dh", MSDA_CASES)
def test_plain_msda_matches_xla_f32(Lq, shapes, nP, dh):
    vals, loc, aw = _msda_inputs(Lq=Lq, shapes=shapes, nP=nP, dh=dh)
    got = ms_deform_attn([_T(v) for v in vals], _T(loc), _T(aw))
    want = jax_ms_deform_attn([jnp.asarray(v) for v in vals], jnp.asarray(loc),
                              jnp.asarray(aw))
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Lq,shapes,nP,dh", MSDA_CASES)
def test_plain_msda_matches_sep_kernel_bf16(Lq, shapes, nP, dh):
    vals, loc, aw = _msda_inputs(Lq=Lq, shapes=shapes, nP=nP, dh=dh, seed=1)
    vals_bf = [torch.from_numpy(v).bfloat16() for v in vals]
    got = ms_deform_attn(vals_bf, _T(loc), _T(aw)).float().numpy()
    ref = np.asarray(msda_sep.ms_deform_attn_sep(
        [jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in vals_bf],
        jnp.asarray(loc), jnp.asarray(aw), interpret=True), np.float32)
    assert np.abs(got - ref).max() <= 0.01 * np.abs(ref).max() + 1e-4


def test_plain_msda_out_of_range_is_zero():
    vals, loc, aw = _msda_inputs(lo=1.5, hi=3.0)
    out = ms_deform_attn([_T(v) for v in vals], _T(loc), _T(aw))
    assert out.abs().max().item() == 0.0
    out = ms_deform_attn([_T(v) for v in vals], _T(-loc), _T(aw))
    assert out.abs().max().item() == 0.0


def test_fast_backward_matches_jax_fast_bwd():
    vals, loc, aw = _msda_inputs(B=1, Lq=16, shapes=((8, 8), (4, 4), (2, 2)), seed=2)
    g = np.random.default_rng(3).normal(size=(1, 16, 8 * 32)).astype(np.float32)
    tv = [_T(v).requires_grad_() for v in vals]
    tl, ta = _T(loc).requires_grad_(), _T(aw).requires_grad_()
    out = ms_deform_attn_fast(tv, tl, ta)
    out.backward(_T(g))
    want_v, want_l, want_a = msda_sep._fast_bwd(
        ([jnp.asarray(v) for v in vals], jnp.asarray(loc), jnp.asarray(aw)),
        jnp.asarray(g))
    _close(tl.grad, want_l, atol=1e-5)
    _close(ta.grad, want_a, atol=1e-5)
    for a, b in zip(tv, want_v):
        _close(a.grad, b, atol=1e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    vals, loc, aw = _msda_inputs(seed=4)
    value, shapes = flatten_levels([_T(v) for v in vals])
    before = msda_forward.launches
    got = msda_forward(value, shapes, _T(loc), _T(aw))
    assert msda_forward.launches == before
    torch.testing.assert_close(got, ms_deform_attn_core(value, shapes, _T(loc), _T(aw)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["value_dtype", "loc_dtype", "noncontig", "shapes"])
def test_wrapper_checks_raise(bad):
    vals, loc, aw = _msda_inputs(B=1, Lq=4, seed=5)
    value, shapes = flatten_levels([_T(v) for v in vals])
    loc, aw = _T(loc), _T(aw)
    if bad == "value_dtype":
        value = value.half()
    elif bad == "loc_dtype":
        loc = loc.double()
    elif bad == "noncontig":
        value = torch.cat([value, value], dim=-1)[..., :value.shape[-1]]
    else:
        shapes = shapes[:2]
    with pytest.raises((TypeError, ValueError)):
        MSDAForward._check(value, shapes, loc, aw)
    # the same inputs made right pass, also with the map 2 elements into its
    # buffer (the kernel then loads narrower vectors, tests/test_torch_msda_plan.py)
    vals, loc, aw = _msda_inputs(B=1, Lq=4, seed=5)
    value, shapes = flatten_levels([_T(v) for v in vals])
    MSDAForward._check(value, shapes, _T(loc), _T(aw))
    shifted = torch.zeros(value.numel() + 2)[2:].view(value.shape).copy_(value)
    MSDAForward._check(shifted, shapes, _T(loc), _T(aw))


# ---------------------------------------------------------------- hygiene


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import detrpose_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'detrpose_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('detrpose_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "flax", "detrpose_tpu")]
