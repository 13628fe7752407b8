"""Kernel #1's backward for the locations and weights (csrc/msda_bwd.cu) on
the CPU: its plain twin ``msda_backward_plain``, the closed-form gradients,
against ``torch.autograd.grad`` through ``ms_deform_attn_core``; the choice
of path in the op's backward; its launch plan; its counters.

The twin and autograd compute the same function in float64 in another
order, so they agree within 1e-10 of the largest gradient, and a NaN
gradient stands where autograd's does. The kernel itself is held to the
plain backward on the card (tests/test_torch_cuda.py).
"""
import itertools

import numpy as np
import pytest
import torch

from detrpose_tpu_torch.ops.cuda.msda import (BLOCK_THREADS, backward_path, backward_plan,
                                              ms_deform_attn_fast_flat, msda_backward,
                                              msda_backward_plain)
from detrpose_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core

torch.set_num_threads(2)
SHAPES = [(8, 8), (4, 4), (2, 2)]


def _inputs(B=2, Lq=9, nH=3, dh=4, nP=4, lo=-0.2, hi=1.2, seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    S, nL = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.normal(size=(B, S, nH * dh)))
    loc = torch.from_numpy(rng.uniform(lo, hi, (B, Lq, nH, nL, nP, 2)))
    aw = torch.from_numpy(rng.random((B, Lq, nH, nL, nP)))
    grad_out = torch.from_numpy(rng.normal(size=(B, Lq, nH * dh)))
    return value, loc, aw, grad_out


def _autograd(value, shapes, loc, aw, grad_out):
    loc, aw = loc.clone().requires_grad_(), aw.clone().requires_grad_()
    out = ms_deform_attn_core(value, shapes, loc, aw)
    return torch.autograd.grad(out, (loc, aw), grad_out)


def _assert_matches_autograd(value, loc, aw, grad_out, shapes=SHAPES):
    want = _autograd(value, shapes, loc, aw, grad_out)
    got = msda_backward_plain(value, shapes, loc, aw, grad_out)
    for name, g, w in zip(("locations", "weights"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        scale = w.nan_to_num().abs().max().item()
        err = (g - w).nan_to_num().abs().max().item()
        assert err <= 1e-10 * scale, (name, err, scale)
    return want


@pytest.mark.parametrize("nP", [1, 4, 8])
def test_twin_matches_autograd_at_random_points(nP):
    want = _assert_matches_autograd(*_inputs(nP=nP, seed=nP))
    assert all(w.abs().max() > 0 for w in want)


def test_twin_matches_autograd_on_integer_pixels():
    # x = (i + 0.5) / W: ix = x*W - 0.5 is the whole pixel i, exactly (W a
    # power of two), where the location's gradient jumps; i from -1 to W,
    # so a point on the map's last pixel or just past it takes a corner off
    # the map
    value, loc, aw, grad_out = _inputs(seed=1)
    rng = np.random.default_rng(2)
    for lvl, (H, W) in enumerate(SHAPES):
        sl = loc[:, :, :, lvl]
        pix = torch.from_numpy(rng.integers(-1, max(H, W) + 1, sl.shape))
        size = torch.tensor([W, H], dtype=loc.dtype)
        sl.copy_((pix + 0.5) / size)
    for lvl, (H, W) in enumerate(SHAPES):
        ix = loc[:, :, :, lvl, :, 0] * W - 0.5
        assert torch.equal(ix, torch.floor(ix))
    _assert_matches_autograd(value, loc, aw, grad_out)


@pytest.mark.parametrize("side", ["left", "right", "top", "bottom", "far"])
def test_twin_matches_autograd_off_the_map(side):
    # every point within a pixel of one edge, or past it, so that one or
    # both of its corners on that side lie off the map
    value, loc, aw, grad_out = _inputs(lo=0.0, hi=1.0, seed=3)
    rng = np.random.default_rng(4)
    near = torch.from_numpy(rng.uniform(-0.15, 0.1, loc.shape[:-1]))
    axis = {"left": 0, "right": 0, "top": 1, "bottom": 1}
    if side == "far":
        loc.copy_(torch.from_numpy(rng.uniform(-3.0, 4.0, loc.shape)))
    else:
        loc[..., axis[side]] = near if side in ("left", "top") else 1.0 - near
    _assert_matches_autograd(value, loc, aw, grad_out)


def test_twin_matches_autograd_at_nan_and_huge_points():
    # one or both coordinates of each point NaN, 1e30 or -1e30: the gradients
    # NaN exactly where autograd's are, and equal elsewhere
    value, loc, aw, grad_out = _inputs(lo=0.0, hi=1.0, seed=5)
    rng = np.random.default_rng(6)
    bad = torch.from_numpy(rng.choice(np.array([np.nan, 1e30, -1e30]), loc.shape))
    which = rng.integers(0, 4, loc.shape[:-1])     # 3: the point stays
    hit = torch.from_numpy(np.stack([(which == 0) | (which == 2),
                                     (which == 1) | (which == 2)], axis=-1))
    loc = torch.where(hit, bad, loc)
    want = _assert_matches_autograd(value, loc, aw, grad_out)
    assert torch.isnan(want[0]).any() and torch.isnan(want[1]).any()
    assert (want[0].nan_to_num() != 0).any()


def test_twin_in_float32_from_bf16_values():
    # the types the kernel takes: bf16 values and output gradient, float32
    # points; the twin returns float32 like autograd, within float32 rounding
    value, loc, aw, grad_out = _inputs(seed=7)
    value, grad_out = value.to(torch.bfloat16), grad_out.to(torch.bfloat16)
    loc, aw = loc.float(), aw.float()
    want = _autograd(value, SHAPES, loc, aw, grad_out)
    got = msda_backward_plain(value, SHAPES, loc, aw, grad_out)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


DEVICES = ["cpu", "cuda"]
NEEDS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "".join("vla"[i] if x else "-"
                                                               for i, x in enumerate(n)))
def test_backward_path(device, grad_enabled, needs):
    # the kernel only on the card, for a backward that is not recorded and
    # wants the locations' or the weights' gradient and not the value's
    kernel = device == "cuda" and not grad_enabled and not needs[0] and (needs[1] or needs[2])
    assert backward_path(device, grad_enabled, needs) == ("kernel" if kernel else "plain")


@pytest.mark.parametrize("dh,itemsize,offset", [(32, 2, 0), (32, 2, 2), (32, 4, 0), (12, 2, 0),
                                                (48, 2, 0), (96, 2, 2), (256, 4, 4), (8, 2, 0)])
def test_backward_plan_covers_each_head(dh, itemsize, offset):
    # a head's lanes are a power of two within one warp; its chunks of
    # lanes x vec channels cover dh, the last one not wholly past it
    heads = 1000
    plan = backward_plan(dh, itemsize, (256 + offset, 512), heads)
    assert dh % plan.vec == 0 and plan.vec * itemsize in (2, 4, 8, 16)
    assert plan.lanes & (plan.lanes - 1) == 0 and 1 <= plan.lanes <= 32
    assert (plan.chunks - 1) * plan.lanes * plan.vec < dh <= plan.chunks * plan.lanes * plan.vec
    assert plan.blocks * BLOCK_THREADS >= heads * plan.lanes > (plan.blocks - 1) * BLOCK_THREADS
    if dh == 32 and itemsize == 2 and offset == 0:
        assert plan == (8, 4, 1, -(-heads * 4 // BLOCK_THREADS))   # L: 4 lanes of 16 bytes


def test_wrapper_refuses_the_cpu_and_counts_nothing():
    # the kernel runs on the card alone; a CPU backward goes through autograd
    value, loc, aw, grad_out = _inputs(seed=8)
    before = (msda_backward.launches, msda_backward.plain)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        msda_backward(value, SHAPES, loc, aw, grad_out)
    assert (msda_backward.launches, msda_backward.plain) == before


@pytest.mark.parametrize("case", ["loc_aw", "value", "create_graph"])
def test_cpu_backward_counts_nothing(case):
    # the op's backward on the CPU takes autograd through the plain version
    # whatever it is asked for, and leaves both counters as they were
    value, loc, aw, grad_out = (t.float() for t in _inputs(seed=9))
    value.requires_grad_(case == "value")
    loc.requires_grad_()
    aw.requires_grad_()
    before = (msda_backward.launches, msda_backward.plain)
    with torch.enable_grad():
        out = ms_deform_attn_fast_flat(value, SHAPES, loc, aw)
        wrt = (value, loc, aw) if case == "value" else (loc, aw)
        grads = torch.autograd.grad(out, wrt, grad_out, create_graph=case == "create_graph")
    assert (msda_backward.launches, msda_backward.plain) == before
    want = _autograd(value.detach(), SHAPES, loc.detach(), aw.detach(), grad_out)
    for g, w in zip(grads[-2:], want):
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()
