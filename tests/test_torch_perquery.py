"""Kernel #2 of the port, the per-query MSDA forward
(detrpose_tpu_torch/ops/cuda/msda_perquery.py), on the CPU.

On a CPU tensor its wrapper runs its plain version through the packed
per-head layout, so these tests exercise the packing and unpacking the card
runs too. It is held to the TPU kernel it replaces,
``detrpose_tpu/ops/pallas/msda.py::ms_deform_attn_pallas`` in interpret mode
(with its query tile cut to 16, as tests/test_pallas_msda.py does), at 1e-5
relative and absolute: both sum the same float32 products in another order.
Inputs come from numpy.random.default_rng.
"""
import pytest
import torch

import jax.numpy as jnp

from detrpose_tpu.ops.pallas import msda as jax_msda_pallas

from detrpose_tpu_torch.ops.cuda.msda_perquery import (MSDAPerQuery, ms_deform_attn_pallas,
                                                       ms_deform_attn_pallas_flat,
                                                       msda_perquery, msda_perquery_plain,
                                                       pack_points, pack_value)
from detrpose_tpu_torch.ops.ms_deform_attn import flatten_levels, ms_deform_attn_core

from test_torch_ops import _T, _close, _msda_inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("nL,nP,dh", [(2, 6, 16), (3, 4, 32), (3, 4, 48)])
def test_perquery_matches_pallas_interpret(nL, nP, dh, monkeypatch):
    # Lq 37 leaves a ragged query tile; points reach past every border
    monkeypatch.setattr(jax_msda_pallas, "_TQ", 16)
    shapes = ((9, 11), (5, 6), (3, 3))[:nL]
    vals, loc, aw = _msda_inputs(B=1, Lq=37, nH=2, nP=nP, dh=dh, shapes=shapes, seed=6,
                                 lo=-0.15, hi=1.15)
    want = jax_msda_pallas.ms_deform_attn_pallas(
        [jnp.asarray(v) for v in vals], jnp.asarray(loc), jnp.asarray(aw), interpret=True)
    got = ms_deform_attn_pallas([_T(v) for v in vals], _T(loc), _T(aw))
    _close(got, want, rtol=1e-5, atol=1e-5)
    value, flat_shapes = flatten_levels([_T(v) for v in vals])
    torch.testing.assert_close(ms_deform_attn_pallas_flat(value, flat_shapes, _T(loc), _T(aw)),
                               got, rtol=0, atol=0)


def test_perquery_wrapper_on_cpu_runs_plain_and_counts_nothing():
    vals, loc, aw = _msda_inputs(seed=7)
    value, shapes = flatten_levels([_T(v) for v in vals])
    B, Lq, nH = loc.shape[:3]
    vflat = pack_value(value, nH)
    locp, awp = pack_points(_T(loc), _T(aw))
    assert vflat.shape == (B, nH, value.shape[1], 32) and awp.shape == (B, nH, Lq, 12)
    before = msda_perquery.launches
    got = msda_perquery(vflat, shapes, locp, awp)
    assert msda_perquery.launches == before
    torch.testing.assert_close(got, msda_perquery_plain(vflat, shapes, locp, awp),
                               rtol=0, atol=0)
    # the packed plain version is the flat one in another layout
    want = ms_deform_attn_core(value, shapes, _T(loc), _T(aw))
    _close(got.transpose(1, 2).reshape(B, Lq, -1), want, rtol=1e-6, atol=1e-6)


def test_perquery_out_of_range_is_zero():
    vals, loc, aw = _msda_inputs(lo=1.5, hi=3.0, seed=8)
    for sign in (1, -1):
        out = ms_deform_attn_pallas([_T(v) for v in vals], _T(sign * loc), _T(aw))
        assert out.abs().max().item() == 0.0


@pytest.mark.parametrize("bad", ["value_dtype", "loc_dtype", "noncontig", "shapes",
                                 "levels", "dh", "points"])
def test_perquery_checks_raise(bad):
    nP, dh, shapes = 4, 32, [(4, 4), (2, 2)]
    if bad == "dh":
        dh = 80
    elif bad == "levels":
        shapes = [(2, 2)] * 5
    S, nL = sum(h * w for h, w in shapes), len(shapes)
    value = torch.zeros(1, 2, S, dh)
    # a point count that is no multiple of the levels' (any count that is
    # one runs: 2 x 17 below, the grid branch's 3 x 16)
    n_pts = nL * nP + (1 if bad == "points" else 0)
    loc = torch.zeros(1, 2, 3, n_pts * 2)
    aw = torch.zeros(1, 2, 3, n_pts)
    if bad == "value_dtype":
        value = value.half()
    elif bad == "loc_dtype":
        loc = loc.double()
    elif bad == "noncontig":
        value = value.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "shapes":
        shapes = shapes[:1]
    with pytest.raises((TypeError, ValueError)):
        MSDAPerQuery._check(value, shapes, loc, aw)
    if bad == "points":
        MSDAPerQuery._check(value, shapes, torch.zeros(1, 2, 3, 2 * 34),
                            torch.zeros(1, 2, 3, 34))
    if bad not in ("value_dtype", "loc_dtype", "noncontig", "shapes"):
        return
    # and the checks pass on the same tensors made right
    MSDAPerQuery._check(torch.zeros(1, 2, 20, 32), [(4, 4), (2, 2)],
                        torch.zeros(1, 2, 3, 16), torch.zeros(1, 2, 3, 8))
