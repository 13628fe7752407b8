"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports torch and numpy only, so on a
machine with a card and no JAX it runs without the suite's conftest:

  python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: float32 within 1e-5 of max|ref| (sums in another order); bf16
values within 1% of max|ref| (one bf16 rounding of the output); the
per-point kernels #3–#5 within 1e-5 of max|ref| (bf16 values, float32
output, the same sums in another order).
"""
import os

import numpy as np
import pytest
import torch

# deterministic cuBLAS for the training tests' deterministic mode; read when
# cuBLAS starts, so set before any test runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from detrpose_tpu_torch.models.decoder import MSDeformAttn
from detrpose_tpu_torch.ops.cuda.msda import (ms_deform_attn_fast_flat, msda_backward,
                                              msda_forward)
from detrpose_tpu_torch.ops.cuda.msda_perquery import (msda_perquery, msda_perquery_plain,
                                                       pack_points, pack_value)
from detrpose_tpu_torch.ops.cuda.msda import SMEM_OPTIN, TPOSE_BUDGET
from detrpose_tpu_torch.ops.cuda.msda_ablate import MODES, msda_ablate, msda_ablate_plain
from detrpose_tpu_torch.ops.cuda.msda_colsin import (MSDAColsin, ms_deform_attn_colsin,
                                                     msda_colsin, msda_colsin_plain)
from detrpose_tpu_torch.ops.cuda.msda_tpose import (MSDATpose, ms_deform_attn_tpose,
                                                    msda_tpose, msda_tpose_plain)
from detrpose_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core
from detrpose_tpu_torch.ops.msda_pack import column_planes, pack_values_tposed, pack_values_xminor
from detrpose_tpu_torch.ops.msda_pack import pack_points as pack_point_levels

SHAPES = [(16, 16), (8, 8), (4, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, dtype, B=2, Lq=135, nH=8, dh=32, nP=4, lo=-0.1, hi=1.1, seed=0,
            shapes=SHAPES):
    rng = np.random.default_rng(seed)
    S, nL = sum(h * w for h, w in shapes), len(shapes)
    value = torch.from_numpy(rng.normal(size=(B, S, nH * dh)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(lo, hi, (B, Lq, nH, nL, nP, 2)).astype(np.float32))
    aw = rng.random((B, Lq, nH, nL, nP)).astype(np.float32)
    aw = torch.from_numpy(aw / aw.sum(axis=(-1, -2), keepdims=True))
    return value.to(dev, dtype), loc.to(dev), aw.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("dh,nP", [(32, 4), (16, 6), (48, 4)])
def test_kernel_matches_plain(cuda, dtype, rel, dh, nP):
    value, loc, aw = _inputs(cuda, dtype, dh=dh, nP=nP)
    before = msda_forward.launches
    got = msda_forward(value, SHAPES, loc, aw).float()
    want = ms_deform_attn_core(value, SHAPES, loc, aw).float()
    assert msda_forward.launches == before + 1
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


@pytest.mark.gpu
def test_kernel_out_of_range_is_zero(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, lo=1.5, hi=3.0)
    assert msda_forward(value, SHAPES, loc, aw).abs().max().item() == 0.0


@pytest.mark.gpu
def test_module_launches_kernel_and_matches_plain(cuda):
    attn = MSDeformAttn(256, 3, 8, 4).to(cuda)
    with torch.no_grad():
        attn.sampling_offsets.weight.normal_(0, 0.02)
        attn.attention_weights.weight.normal_(0, 0.02)
    rng = np.random.default_rng(1)
    query = torch.from_numpy(rng.normal(size=(2, 90, 256)).astype(np.float32)).to(cuda)
    refs = torch.from_numpy(rng.uniform(0, 1, (2, 90, 2)).astype(np.float32)).to(cuda)
    value = _inputs(cuda, torch.float32)[0]
    with torch.no_grad():
        before = msda_forward.launches
        got = attn(query, refs, value, SHAPES)
        assert msda_forward.launches == before + 1
        attn.msda_backend = "gather"
        want = attn(query, refs, value, SHAPES)
        assert msda_forward.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_backward_is_the_plain_versions(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, B=1, Lq=16, seed=2)
    g = torch.randn(1, 16, 256, device=cuda)
    grads = []
    for fn in (ms_deform_attn_fast_flat, ms_deform_attn_core):
        ins = [t.clone().requires_grad_() for t in (value, loc, aw)]
        fn(ins[0], SHAPES, ins[1], ins[2]).backward(g)
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6


def _packed(value, loc, aw):
    """Kernel #2's layout of the inputs of ``_inputs``."""
    return (pack_value(value, loc.shape[2]),) + pack_points(loc, aw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("dh,nP", [(32, 4), (16, 6), (48, 4)])
def test_perquery_kernel_matches_plain(cuda, dtype, rel, dh, nP):
    # Lq 135 is not a multiple of the kernel's 8-query tile
    vflat, locp, awp = _packed(*_inputs(cuda, dtype, dh=dh, nP=nP))
    before = msda_perquery.launches
    got = msda_perquery(vflat, SHAPES, locp, awp).float()
    want = msda_perquery_plain(vflat, SHAPES, locp, awp).float()
    assert msda_perquery.launches == before + 1
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


@pytest.mark.gpu
def test_perquery_kernel_out_of_range_is_zero(cuda):
    vflat, locp, awp = _packed(*_inputs(cuda, torch.float32, lo=1.5, hi=3.0))
    assert msda_perquery(vflat, SHAPES, locp, awp).abs().max().item() == 0.0


@pytest.mark.gpu
def test_module_pallas_launches_perquery_once(cuda):
    attn = MSDeformAttn(256, 3, 8, 4, msda_backend="pallas").to(cuda)
    with torch.no_grad():
        attn.sampling_offsets.weight.normal_(0, 0.02)
        attn.attention_weights.weight.normal_(0, 0.02)
    rng = np.random.default_rng(3)
    query = torch.from_numpy(rng.normal(size=(2, 90, 256)).astype(np.float32)).to(cuda)
    refs = torch.from_numpy(rng.uniform(0, 1, (2, 90, 2)).astype(np.float32)).to(cuda)
    value = _inputs(cuda, torch.float32)[0]
    with torch.no_grad():
        before = (msda_perquery.launches, msda_forward.launches)
        got = attn(query, refs, value, SHAPES)
        assert (msda_perquery.launches, msda_forward.launches) == (before[0] + 1, before[1])
        attn.msda_backend = "gather"
        want = attn(query, refs, value, SHAPES)
        assert msda_perquery.launches == before[0] + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---- kernels #1 and #2 off their 16-byte path: a bf16 head of 12 channels
# (8-byte loads), 3 points (the generic point loop), odd level sizes and a
# ragged last block; 4 levels; a map that starts 2 elements into its buffer

OFF_PATH = {"odd": dict(B=1, Lq=37, nH=3, dh=12, nP=3, shapes=[(7, 9), (5, 3)]),
            "levels4": dict(shapes=SHAPES + [(2, 2)]),
            "offset": {}}


def _shifted(t, k=2):
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape)
    return out.copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", sorted(OFF_PATH))
def test_kernels_match_plain_off_the_16_byte_path(cuda, dtype, rel, case):
    kw = OFF_PATH[case]
    value, loc, aw = _inputs(cuda, dtype, seed=5, **kw)
    shapes = kw.get("shapes", SHAPES)
    vflat, locp, awp = _packed(value, loc, aw)
    if case == "offset":
        value, vflat = _shifted(value), _shifted(vflat)
        assert value.data_ptr() % 16 and vflat.data_ptr() % 16
    for kernel, args, plain in (
            (msda_forward, (value, shapes, loc, aw), ms_deform_attn_core),
            (msda_perquery, (vflat, shapes, locp, awp), msda_perquery_plain)):
        before = kernel.launches
        got = kernel(*args).float()
        want = plain(*args).float()
        assert kernel.launches == before + 1
        assert (got - want).abs().max().item() <= rel * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_nan_and_huge_points_are_zero(cuda, dtype):
    # one or both coordinates of every point NaN, 1e30 or -1e30; the plain
    # version carries a NaN through, the kernels give exactly 0
    value, loc, aw = _inputs(cuda, dtype, lo=0.0, hi=1.0, seed=6)
    rng = np.random.default_rng(7)
    bad = rng.choice(np.array([np.nan, 1e30, -1e30], np.float32), loc.shape)
    which = rng.integers(0, 3, loc.shape[:-1])
    hit = np.stack([which != 1, which != 0], axis=-1)
    loc = torch.where(torch.from_numpy(hit).to(cuda), torch.from_numpy(bad).to(cuda), loc)
    vflat, locp, awp = _packed(value, loc, aw)
    assert msda_forward(value, SHAPES, loc, aw).abs().max().item() == 0.0
    assert msda_perquery(vflat, SHAPES, locp, awp).abs().max().item() == 0.0


# ---- kernel #1's backward for the locations and weights (csrc/msda_bwd.cu)
# against the op's plain path, autograd through the plain version: float32
# gradients of the same values in another order, so within 1e-5 of max|ref|
# whatever the value type, and NaN where the plain version's are

L_EVAL_SHAPES = [(80, 80), (40, 40), (20, 20)]


def _grad_out(value, Lq, seed):
    g = torch.Generator(value.device).manual_seed(seed)
    return torch.randn(value.shape[0], Lq, value.shape[2], device=value.device,
                       generator=g).to(value.dtype)


def _plain_backward(value, shapes, loc, aw, grad_out):
    ins = [loc.clone().requires_grad_(), aw.clone().requires_grad_()]
    with torch.enable_grad():
        out = ms_deform_attn_core(value, shapes, ins[0], ins[1])
        return torch.autograd.grad(out, ins, grad_out)


def _assert_backward_matches_plain(value, shapes, loc, aw, grad_out, rel=1e-5):
    before = msda_backward.launches
    got = msda_backward(value, shapes, loc, aw, grad_out)
    assert msda_backward.launches == before + 1
    want = _plain_backward(value, shapes, loc, aw, grad_out)
    for name, a, b in zip(("locations", "weights"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        err = (a - b).nan_to_num().abs().max().item()
        assert err <= rel * b.nan_to_num().abs().max().item(), (name, err)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_at_l_eval_shapes(cuda, dtype):
    # the energy cell's launch: bs 32, 60 queries x 18 tokens, L's levels
    value, loc, aw = _inputs(cuda, dtype, B=32, Lq=1080, shapes=L_EVAL_SHAPES, seed=30)
    want = _assert_backward_matches_plain(value, L_EVAL_SHAPES, loc, aw,
                                          _grad_out(value, 1080, 0))
    assert all(w.abs().max().item() > 0 for w in want)


# the forward's cases off the 16-byte path, and a head wider than a warp of
# lanes: 96 channels on a map 1 element into its buffer take 1-element
# loads, 96 lanes, so 3 chunks of 32
BACKWARD_OFF_PATH = dict(OFF_PATH, chunks=dict(B=1, Lq=37, nH=2, dh=96, nP=2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BACKWARD_OFF_PATH))
def test_backward_kernel_matches_plain_off_the_16_byte_path(cuda, dtype, case):
    kw = BACKWARD_OFF_PATH[case]
    value, loc, aw = _inputs(cuda, dtype, seed=32, **kw)
    shapes = kw.get("shapes", SHAPES)
    if case in ("offset", "chunks"):
        value = _shifted(value, 2 if case == "offset" else 1)
        assert value.data_ptr() % 16
    _assert_backward_matches_plain(value, shapes, loc, aw, _grad_out(value, loc.shape[1], 1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_nan_and_huge_points(cuda, dtype):
    # one or both coordinates of some points NaN, 1e30 or -1e30: the
    # kernel's gradients are NaN where the plain version's are, equal
    # elsewhere
    value, loc, aw = _inputs(cuda, dtype, lo=0.0, hi=1.0, seed=33)
    rng = np.random.default_rng(34)
    bad = rng.choice(np.array([np.nan, 1e30, -1e30], np.float32), loc.shape)
    which = rng.integers(0, 4, loc.shape[:-1])     # 3: the point stays
    hit = np.stack([(which == 0) | (which == 2), (which == 1) | (which == 2)], axis=-1)
    loc = torch.where(torch.from_numpy(hit).to(cuda), torch.from_numpy(bad).to(cuda), loc)
    want = _assert_backward_matches_plain(value, SHAPES, loc, aw, _grad_out(value, 135, 2))
    assert torch.isnan(want[0]).any() and torch.isnan(want[1]).any()


@pytest.mark.gpu
def test_backward_counters(cuda):
    # the op's backward launches the kernel for the locations' and weights'
    # gradients alone, once a backward; a value that needs its gradient, or
    # a backward that is itself recorded, takes the plain path, counted
    value, loc, aw = _inputs(cuda, torch.bfloat16, B=1, Lq=16, seed=35)
    g = _grad_out(value, 16, 3)

    def grads(wrt="la", create_graph=False):
        ins = [value.clone().requires_grad_("v" in wrt), loc.clone().requires_grad_("l" in wrt),
               aw.clone().requires_grad_("a" in wrt)]
        with torch.enable_grad():
            out = ms_deform_attn_fast_flat(ins[0], SHAPES, ins[1], ins[2])
            return torch.autograd.grad(out, [t for t in ins if t.requires_grad], g,
                                       create_graph=create_graph)

    want = _plain_backward(value, SHAPES, loc, aw, g)
    for wrt, launched, picked in (("la", 1, want), ("la", 1, want), ("l", 1, want[:1]),
                                  ("a", 1, want[1:])):
        before = (msda_backward.launches, msda_backward.plain)
        got = grads(wrt)
        assert (msda_backward.launches, msda_backward.plain) == (before[0] + launched,
                                                                 before[1]), wrt
        for a, b in zip(got, picked):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    for wrt, create_graph in (("vla", False), ("la", True)):
        before = (msda_backward.launches, msda_backward.plain)
        got = grads(wrt, create_graph)
        assert (msda_backward.launches, msda_backward.plain) == (before[0], before[1] + 1)
        for a, b in zip(got[-2:], want):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.gpu
def test_n_energy_pipeline_matches_the_plain_backward(cuda, exact_f32, monkeypatch):
    # N with gradient energy refinement served through build_pipeline in
    # float32: each of its 3 refinement steps takes the kernel; the same
    # model with the path choice forced to the plain path gives the same
    # logits and keypoints within 1e-4, the refinement's step within 1e-3 of
    # its size, and the served scores within 1e-4
    from detrpose_tpu_torch.ops.cuda import msda as msda_module
    from detrpose_tpu_torch.tools.infer import build_pipeline

    run = build_pipeline("n", res=320, dtype=torch.float32, device=cuda,
                         use_energy_refinement=True, grad_energy=True)
    x = torch.rand(2, 3, 320, 320, generator=torch.Generator().manual_seed(36)).to(cuda)
    frames = np.random.default_rng(36).integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
    wh = np.array([[320, 240]] * 2, np.float32)

    def served():
        entered = []
        hook = run.model.transformer.lqe_embed[-1].register_forward_hook(
            lambda m, a, out: entered.append(a[1].float()))
        before = (msda_backward.launches, msda_backward.plain)
        try:
            with torch.no_grad():
                out = run.model(x)
                scores = run(frames, wh)[0]
        finally:
            hook.remove()
        counts = (msda_backward.launches - before[0], msda_backward.plain - before[1])
        step = out["pred_keypoints"].float().reshape(entered[0].shape) - entered[0]
        return out, step, scores, counts

    out, step, scores, counts = served()
    assert counts == (6, 0)
    monkeypatch.setattr(msda_module, "backward_path", lambda *args: "plain")
    want, want_step, want_scores, counts = served()
    assert counts == (0, 6)
    for k in ("pred_logits", "pred_keypoints"):
        assert (out[k] - want[k]).abs().max().item() < 1e-4, k
    assert want_step.abs().max().item() > 0
    assert ((step - want_step).norm() / want_step.norm()).item() < 1e-3
    assert (scores - want_scores).abs().max().item() < 1e-4


# ---- kernels #3–#5, the per-point variants and ablations: both sides take
# the same packed bf16 values and sum in float32, so 1e-5 of max|ref|

def _per_point(dev, dh=32, nP=4, lo=-0.1, hi=1.1, seed=4, shapes=SHAPES, **kw):
    value, loc, aw = _inputs(dev, torch.float32, dh=dh, nP=nP, lo=lo, hi=hi, seed=seed,
                             shapes=shapes, **kw)
    B, Lq, nH = loc.shape[:3]
    levels, start = [], 0
    for H, W in shapes:
        levels.append(value[:, start:start + H * W].reshape(B, H, W, nH, dh))
        start += H * W
    return levels, pack_point_levels(loc, aw, shapes)


def _rel_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dh,nP", [(32, 4), (16, 6), (48, 4), (128, 4), (256, 4)])
def test_colsin_kernel_matches_plain(cuda, dh, nP):
    # dh 128 and 256: 16 and 32 threads a point, 16 and 8 points a block
    levels, pts = _per_point(cuda, dh, nP)
    vals = pack_values_xminor(levels)
    cols = column_planes(SHAPES, dh, cuda)
    before = msda_colsin.launches
    got = msda_colsin(pts, vals, cols, SHAPES)
    assert msda_colsin.launches == before + 1
    assert _rel_err(got, msda_colsin_plain(pts, vals, SHAPES)) <= 1e-5


@pytest.mark.gpu
def test_colsin_one_point_a_block(cuda):
    # dh 256 on maps 2 bytes (one element) into their buffers: one channel a
    # thread, so a point takes all 256 threads of a block
    levels, pts = _per_point(cuda, 256, 4, B=1, Lq=16, nH=2)
    vals = [_shifted(v, 1) for v in pack_values_xminor(levels)]
    assert MSDAColsin.plan(vals, 256, pts[0][0].shape[-1]).slots == 1
    got = msda_colsin(pts, vals, column_planes(SHAPES, 256, cuda), SHAPES, tile=37)
    assert _rel_err(got, msda_colsin_plain(pts, vals, SHAPES)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dh,nP", [(32, 4), (16, 6), (48, 4)])
def test_tpose_kernel_matches_plain(cuda, dh, nP):
    levels, pts = _per_point(cuda, dh, nP)
    vals = pack_values_tposed(levels)
    before = msda_tpose.launches
    got = msda_tpose(pts, vals, SHAPES)
    assert msda_tpose.launches == before + 1
    assert _rel_err(got, msda_tpose_plain(pts, vals, SHAPES)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 1024, 37])
@pytest.mark.parametrize("mode", ["full", "no_cexp", "stage1_only", "io_only"])
def test_ablate_kernel_matches_plain(cuda, mode, tile):
    levels, pts = _per_point(cuda)
    vals = pack_values_xminor(levels)
    before = msda_ablate.launches
    got = msda_ablate(mode, pts, vals, SHAPES, tile)
    # no_cexp launches its row pass and its point pass
    assert msda_ablate.launches == before + (2 if mode == "no_cexp" else 1)
    assert _rel_err(got, msda_ablate_plain(mode, pts, vals, SHAPES)) <= 1e-5


@pytest.mark.gpu
def test_per_point_kernels_out_of_range_are_zero(cuda):
    levels, pts = _per_point(cuda, lo=1.5, hi=3.0)
    xminor, tposed = pack_values_xminor(levels), pack_values_tposed(levels)
    for out in (msda_colsin(pts, xminor, column_planes(SHAPES, 32, cuda), SHAPES),
                msda_tpose(pts, tposed, SHAPES),
                msda_ablate("full", pts, xminor, SHAPES)):
        assert out.abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("op", [ms_deform_attn_colsin, ms_deform_attn_tpose])
def test_variant_ops_match_gather(cuda, op):
    # the op casts the values to bf16; the gather takes the same rounded values
    levels, _ = _per_point(cuda)
    _, loc, aw = _inputs(cuda, torch.float32, seed=4)
    levels = [v.bfloat16().float() for v in levels]
    want = ms_deform_attn_core(torch.cat([v.flatten(1, 2).flatten(2) for v in levels], 1),
                               SHAPES, loc, aw)
    assert _rel_err(op(levels, loc, aw), want) <= 1e-5


# ---- kernels #3, #4 and #5 off their 16-byte path and bulk fill: a bf16 head of
# 12 channels (8-byte loads; column rows of 168 and 120 bytes, filled by the
# threads), 3 points, odd level sizes; 4 levels; every map 2 elements into
# its buffer (2-byte loads; thread fill)

PER_POINT_OFF_PATH = {"odd": dict(B=1, Lq=37, nH=3, dh=12, nP=3, shapes=[(7, 9), (5, 3)]),
                      "levels4": dict(shapes=SHAPES + [(2, 2)]),
                      "offset": {}}


def _per_point_case(dev, case, **kw):
    kw = dict(PER_POINT_OFF_PATH[case], **kw)
    levels, pts = _per_point(dev, seed=8, **kw)
    shapes = kw.get("shapes", SHAPES)
    xminor, tposed = pack_values_xminor(levels), pack_values_tposed(levels)
    if case == "offset":
        xminor, tposed = [_shifted(v) for v in xminor], [_shifted(v) for v in tposed]
        assert all(v.data_ptr() % 16 for v in xminor + tposed)
    return pts, xminor, tposed, shapes


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PER_POINT_OFF_PATH))
def test_per_point_kernels_match_plain_off_the_16_byte_path(cuda, case):
    pts, xminor, tposed, shapes = _per_point_case(cuda, case)
    before = msda_tpose.launches
    got = msda_tpose(pts, tposed, shapes)
    assert msda_tpose.launches == before + 1
    assert _rel_err(got, msda_tpose_plain(pts, tposed, shapes)) <= 1e-5
    cols = column_planes(shapes, xminor[0].shape[-1] // shapes[0][1], cuda)
    want = msda_colsin_plain(pts, xminor, shapes)
    for tile in (256, 1024, 37):
        assert _rel_err(msda_colsin(pts, xminor, cols, shapes, tile), want) <= 1e-5
    for mode in MODES:
        want = msda_ablate_plain(mode, pts, xminor, shapes)
        for tile in (256, 1024, 37):
            assert _rel_err(msda_ablate(mode, pts, xminor, shapes, tile), want) <= 1e-5


def _off_map(pts, seed, y_only=False):
    """``pts`` with one or both coordinates of every point (the y of every
    point, ``y_only``) NaN, 1e30 or -1e30."""
    rng = np.random.default_rng(seed)
    out = []
    for ix, iy, a in pts:
        bad = rng.choice(np.array([np.nan, 1e30, -1e30], np.float32), (2,) + ix.shape)
        which = rng.integers(1 if y_only else 0, 3, ix.shape)
        hit = [torch.from_numpy(h).to(ix.device) for h in (which != 1, which != 0)]
        bad = torch.from_numpy(bad).to(ix.device)
        out.append((torch.where(hit[0], bad[0], ix), torch.where(hit[1], bad[1], iy), a))
    return out


@pytest.mark.gpu
def test_per_point_kernels_nan_and_huge_points_are_zero(cuda):
    # #3, #4 and #5 full: one or both coordinates of every point NaN, 1e30 or
    # -1e30; stage1_only and no_cexp read only y, so the y of every point
    # (io_only sums ix by definition, so it is not among them)
    levels, pts = _per_point(cuda, lo=0.0, hi=1.0, seed=9)
    xminor, tposed = pack_values_xminor(levels), pack_values_tposed(levels)
    bad_pts = _off_map(pts, 10)
    cols = column_planes(SHAPES, 32, cuda)
    assert msda_colsin(bad_pts, xminor, cols, SHAPES).abs().max().item() == 0.0
    assert msda_tpose(bad_pts, tposed, SHAPES).abs().max().item() == 0.0
    assert msda_ablate("full", bad_pts, xminor, SHAPES).abs().max().item() == 0.0
    bad_y = _off_map(pts, 11, y_only=True)
    for mode in ("stage1_only", "no_cexp"):
        assert msda_ablate(mode, bad_y, xminor, SHAPES).abs().max().item() == 0.0, mode


@pytest.mark.gpu
@pytest.mark.parametrize("budget,groups", [(SMEM_OPTIN, 1), (TPOSE_BUDGET, 1), (10768, 2),
                                           (5392, 4), (3000, 8), (0, None)])
def test_tpose_at_forced_group_counts(cuda, budget, groups):
    # a smaller shared-memory budget splits one (image, head)'s maps into
    # more channel groups, one block each; below one channel's maps (688
    # bytes here) the taps come from device memory
    levels, pts = _per_point(cuda, seed=11)
    tposed = pack_values_tposed(levels)
    plan = MSDATpose.plan(tposed, SHAPES, 32, pts[0][0].shape[-1], budget)
    assert (plan.groups if plan.staged else None) == groups
    got = msda_tpose(pts, tposed, SHAPES, _budget=budget)
    assert _rel_err(got, msda_tpose_plain(pts, tposed, SHAPES)) <= 1e-5


@pytest.mark.gpu
def test_tpose_past_one_channel_a_block(cuda):
    # the L pyramid at 1920 px: one channel's maps (151.2 KB) exceed the
    # budget, so the kernel reads its taps from device memory
    shapes = [(240, 240), (120, 120), (60, 60)]
    levels, pts = _per_point(cuda, seed=12, shapes=shapes, B=1, Lq=16, nH=2)
    tposed = pack_values_tposed(levels)
    assert not MSDATpose.plan(tposed, shapes, 32, pts[0][0].shape[-1]).staged
    got = msda_tpose(pts, tposed, shapes)
    assert _rel_err(got, msda_tpose_plain(pts, tposed, shapes)) <= 1e-5


# ------------------------------------------------------------------ training
# The DETRPose-L training micro-batch: (64 CDN slots + 60 queries) x 18 tokens
L_TRAIN = dict(B=8, Lq=124 * 18, shapes=[(80, 80), (40, 40), (20, 20)])


@pytest.mark.gpu
def test_op_gradient_matches_plain_at_l_train_shapes(cuda):
    # kernel #1's op: the kernel forward, the plain version's gradient; at
    # the L train shapes in float32 its gradient is the plain version's
    value, loc, aw = _inputs(cuda, torch.float32, B=L_TRAIN["B"], Lq=L_TRAIN["Lq"],
                             shapes=L_TRAIN["shapes"], seed=20)
    g = torch.randn(value.shape[0], loc.shape[1], value.shape[2], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    grads = []
    for fn in (ms_deform_attn_fast_flat, ms_deform_attn_core):
        ins = [t.clone().requires_grad_() for t in (value, loc, aw)]
        before = msda_forward.launches
        fn(ins[0], L_TRAIN["shapes"], ins[1], ins[2]).backward(g)
        assert msda_forward.launches - before == (fn is ms_deform_attn_fast_flat)
        grads.append([t.grad for t in ins])
    for name, a, b in zip(("value", "locations", "weights"), *grads):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item(), name


def _train_setup(dev, backend, remat=False, res=320):
    """N at ``res`` px, batch 2, float32, one CDN batch: the model in training
    and its step (accumulation 2, so the first micro-batch keeps .grad)."""
    from detrpose_tpu_torch.configs import build_model, model_config
    from detrpose_tpu_torch.parallel.train_step import make_train_step
    from detrpose_tpu_torch.tools.benchmark import synthetic_train_batch
    from detrpose_tpu_torch.train.optim import make_optimizer

    model = build_model(model_config("n", msda_backend=backend, remat=remat), device=dev,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.transformer.enc_out_class_embed.weight.mul_(50.0)
    step = make_train_step(model, make_optimizer(model, grad_accum_steps=2), 17,
                           device=dev, compute_dtype=torch.float32, use_ema=False)
    return model, step, synthetic_train_batch(2, res, 17, 60, dev, G=4, seed=3)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module")
def exact_zero_leaves():
    """The leaves whose gradient is 0 in exact arithmetic at ``_train_setup``'s
    step (below 1e-9 of the largest in a float64 run on the CPU): the shifts
    and scales that the encoder's batch-statistics norms cancel. On the card
    in float32 each is a sum of terms up to ~1e9 that cancels to a few of
    their last bits, so any other order of the same sums moves it by tens;
    it is no gradient to compare."""
    model, step, batch = _train_setup(torch.device("cpu"), "gather")
    model.double()
    step(dict(batch, images=batch["images"].double()))
    grads = _grads(model)
    top = max(g.abs().max().item() for g in grads.values())
    return {n for n, g in grads.items() if g.abs().max().item() <= 1e-9 * top}


def _compare_grads(got, want, skip):
    """Each leaf of ``want`` but those in ``skip`` within 1e-3 of its max|g|;
    a leaf whose gradient is 0 up to rounding (a bias that the encoder's
    norms cancel) is held against 1e-5 of the largest |g|."""
    assert got.keys() == want.keys()
    top = max(g.abs().max().item() for g in want.values())
    held = [n for n in want if n not in skip]
    assert len(held) > 0.6 * len(want), (len(held), len(want))
    for n in held:
        tol = 1e-3 * max(want[n].abs().max().item(), 1e-5 * top)
        assert (got[n] - want[n]).abs().max().item() <= tol, n


@pytest.fixture
def exact_f32():
    """Float32 without TF32, and deterministic algorithms: the gradients
    that the encoder's batch-statistics norms cancel to rounding would
    otherwise change with cuDNN's choice of algorithm from run to run."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved[:3]
    torch.use_deterministic_algorithms(saved[3], warn_only=saved[4])


@pytest.mark.gpu
def test_n_train_step_auto_matches_gather(cuda, exact_f32, exact_zero_leaves):
    # one N training micro-step through kernel #1 ("auto", 3 launches) and
    # through the plain version ("gather"): the same losses and gradients
    # (but for those that are 0 in exact arithmetic)
    out = {}
    for backend in ("auto", "gather"):
        model, step, batch = _train_setup(cuda, backend)
        before = msda_forward.launches
        m = step(batch)
        torch.cuda.synchronize()
        assert msda_forward.launches - before == (3 if backend == "auto" else 0)
        out[backend] = (m, _grads(model))
    (ma, ga), (mg, gg) = out["auto"], out["gather"]
    for k, v in mg.items():
        if torch.is_tensor(v):
            assert abs(ma[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-7, k
    _compare_grads(ga, gg, exact_zero_leaves)


@pytest.mark.gpu
def test_remat_gives_the_same_gradients_on_the_card(cuda, exact_f32, exact_zero_leaves):
    # torch.utils.checkpoint around each backbone stage and decoder layer:
    # the recomputed forward launches kernel #1 again, and the gradients are
    # those of the stored forward
    grads = {}
    for remat in (False, True):
        model, step, batch = _train_setup(cuda, "auto", remat=remat)
        before = msda_forward.launches
        step(batch)
        torch.cuda.synchronize()
        assert msda_forward.launches - before == (6 if remat else 3)
        grads[remat] = _grads(model)
    _compare_grads(grads[True], grads[False], exact_zero_leaves)


@pytest.mark.gpu
def test_n_trainer_evaluate_auto_matches_gather(cuda, exact_f32, tmp_path):
    # Trainer.evaluate of N (float32, 160 px, 4 val images, batch 2) through
    # kernel #1 ("auto", 3 launches a batch) and through the plain version:
    # the same detections, to 1e-4 of max|ref|, and the same stats
    from synth_data import make_tiny_coco

    from detrpose_tpu_torch.configs import build_model, model_config
    from detrpose_tpu_torch.data.coco import CocoKeypointDataset
    from detrpose_tpu_torch.data.loader import KeypointLoader
    from detrpose_tpu_torch.data.transforms import EvalTransforms
    from detrpose_tpu_torch.tools.train import val_ground_truth
    from detrpose_tpu_torch.train.trainer import Trainer

    img_dir, ann = make_tiny_coco(str(tmp_path), n_images=4, w=160, h=120, seed=2,
                                  draw=True, structured=True)
    vds = CocoKeypointDataset(img_dir, ann, 17, transforms=EvalTransforms(160))
    out = {}
    for backend in ("auto", "gather"):
        cfg = model_config("n", msda_backend=backend)
        model = build_model(cfg, device=cuda, generator=torch.Generator().manual_seed(3))
        tr = Trainer(model, cfg, val_loader=KeypointLoader(vds, 2, 17, with_cdn=False,
                                                           drop_last=False),
                     val_gts=val_ground_truth(vds, 17), output_dir=str(tmp_path / backend),
                     tensorboard=False, compute_dtype=torch.float32, device=cuda)
        before = msda_forward.launches
        stats = tr.evaluate()
        assert msda_forward.launches - before == (3 * 2 if backend == "auto" else 0)
        out[backend] = (stats, tr.evaluator.dets)
    (sa, da), (sg, dg) = out["auto"], out["gather"]
    assert sa == sg and da.keys() == dg.keys()
    ref = max(np.abs(d["keypoints"]).max() for ds in dg.values() for d in ds)
    for img in dg:
        for a, g in zip(da[img], dg[img], strict=True):
            assert abs(a["score"] - g["score"]) <= 1e-4
            assert np.abs(a["keypoints"] - g["keypoints"]).max() <= 1e-4 * ref


@pytest.mark.gpu
def test_two_rank_step_on_one_card(cuda, exact_f32, exact_zero_leaves, tmp_path):
    # two ranks on the card over gloo (tests/torch_dist_ranks.py), one image
    # each of _train_setup's batch: through kernel #1 ("auto", 3 launches a
    # rank) and through the plain version, the same global loss and
    # all-reduced gradients (but for those that are 0 in exact arithmetic)
    import torch_dist_ranks

    from detrpose_tpu_torch.parallel.dist import run_ranks

    model, _, batch = _train_setup(torch.device("cpu"), "gather")
    torch.save({"sd": model.state_dict(), "batch": batch}, tmp_path / "inputs.pt")
    run_ranks(torch_dist_ranks.card_step, 2, (str(tmp_path),), deadline_s=300.0,
              device="cuda", backend="gloo", local_ranks=[0, 0])
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for g in got:
        assert g["auto"]["launches"] == 3 and g["gather"]["launches"] == 0
        loss = g["gather"]["loss"]
        assert abs(g["auto"]["loss"] - loss) <= 1e-4 * abs(loss) + 1e-7
        _compare_grads(g["auto"]["grads"], g["gather"]["grads"], exact_zero_leaves)
    a, b = (g["auto"]["grads"] for g in got)
    assert all(torch.equal(a[k], v) for k, v in b.items())
