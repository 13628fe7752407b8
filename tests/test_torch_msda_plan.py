"""The launch plans of kernels #1 and #2 (``ops/cuda/msda.py::gather_plan``),
#3 and #5 (``point_plan``) and #4 (``tpose_plan``) and the wrappers' input
checks, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py); the
plans are plain Python: how many channels each thread loads (16 bytes where
the head width and every map's address allow it, else 8, 4 or one element),
how many threads a row or a point takes, and the grid; for kernel #4 the
channel groups whose maps one block's shared memory holds, how each level is
filled, and the reads from device memory where one channel does not fit. The checks must take every input the
kernels take, the narrow and misaligned ones included.
"""
import pytest
import torch

from detrpose_tpu_torch.ops.cuda.msda import (BLOCK_THREADS, SMEM_OPTIN, SMEM_PER_SM,
                                              SMEM_RESERVED, TPOSE_BARRIER, TPOSE_BUDGET,
                                              TPOSE_THREADS, MSDAForward, gather_plan,
                                              point_plan, tpose_plan)
from detrpose_tpu_torch.ops.cuda.msda_ablate import MODES, MSDAAblate, ablate_plan
from detrpose_tpu_torch.ops.cuda.msda_colsin import MSDAColsin
from detrpose_tpu_torch.ops.cuda.msda_perquery import MSDAPerQuery
from detrpose_tpu_torch.ops.cuda.msda_tpose import MSDATpose
from detrpose_tpu_torch.ops.msda_pack import column_planes

ROWS = 32 * 1080          # B x Lq at the eval shapes
BASE = 1 << 20            # an address aligned to 16 bytes


@pytest.mark.parametrize("size,n_heads,dh,itemsize,want", [
    ("L", 8, 32, 2, (8, 32, 4320)),
    ("N", 8, 16, 2, (8, 16, 2160)),
    ("X", 8, 48, 2, (8, 48, 6480)),
    ("L float32", 8, 32, 4, (4, 64, 8640)),
    ("N float32", 8, 16, 4, (4, 32, 4320)),
])
def test_plan_at_model_shapes(size, n_heads, dh, itemsize, want):
    plan = gather_plan(n_heads, dh, itemsize, BASE, ROWS)
    assert (plan.vec, plan.lanes, plan.blocks) == want
    # kernel #2 runs one head per row: a warp covers 32 / lanes queries of a head
    per_head = gather_plan(1, dh, itemsize, BASE, ROWS * n_heads)
    assert per_head.vec == plan.vec and per_head.lanes * n_heads == plan.lanes
    assert per_head.blocks == plan.blocks


@pytest.mark.parametrize("itemsize,offset,vec", [
    (2, 2, 1), (2, 4, 2), (2, 6, 1), (2, 8, 4), (2, 24, 4), (2, 32, 8),
    (4, 4, 1), (4, 8, 2), (4, 12, 1), (4, 16, 4)])
def test_plan_narrows_on_a_misaligned_map(itemsize, offset, vec):
    # a map that starts `offset` bytes past a 16-byte boundary, e.g. a slice
    plan = gather_plan(8, 32, itemsize, BASE + offset, ROWS)
    assert plan.vec == vec and plan.lanes == 8 * 32 // vec


@pytest.mark.parametrize("itemsize,vec", [(2, 4), (4, 4)])
def test_plan_head_width_12(itemsize, vec):
    # 24 bf16 bytes take 8-byte loads; 48 float32 bytes take 16
    plan = gather_plan(3, 12, itemsize, BASE, 37)
    assert (plan.vec, plan.lanes) == (vec, 3 * 12 // vec)


@pytest.mark.parametrize("rows,n_heads,dh", [(37, 3, 12), (135 * 2, 8, 32), (1, 8, 48)])
def test_plan_covers_a_ragged_last_block(rows, n_heads, dh):
    plan = gather_plan(n_heads, dh, 2, BASE, rows)
    n_threads = rows * plan.lanes
    assert (plan.blocks - 1) * BLOCK_THREADS < n_threads <= plan.blocks * BLOCK_THREADS


def test_plan_takes_the_widest_load_that_fits():
    for itemsize in (2, 4):
        for dh in range(1, 70):
            for offset in range(0, 32, itemsize):
                vec = gather_plan(5, dh, itemsize, BASE + offset, 11).vec
                nbytes = vec * itemsize
                assert nbytes in (2, 4, 8, 16) and nbytes >= itemsize
                assert dh % vec == 0 and offset % nbytes == 0
                wider = 2 * nbytes
                assert wider > 16 or dh * itemsize % wider or offset % wider


def _forward_inputs(B, Lq, nH, dh, nP, shapes, offset=0):
    S, nL = sum(h * w for h, w in shapes), len(shapes)
    value = torch.zeros(B * S * nH * dh + offset, dtype=torch.bfloat16)[offset:]
    return (value.view(B, S, nH * dh), shapes, torch.zeros(B, Lq, nH, nL, nP, 2),
            torch.zeros(B, Lq, nH, nL, nP))


TAKEN = {  # inputs the kernels took before their redesign, and take now
    "dh12": dict(B=1, Lq=37, nH=3, dh=12, nP=3, shapes=[(7, 9), (5, 3)]),
    "offset": dict(B=2, Lq=5, nH=8, dh=32, nP=4, shapes=[(4, 4), (2, 2)], offset=2),
    "odd_offset": dict(B=1, Lq=3, nH=2, dh=7, nP=5, shapes=[(3, 5)], offset=1),
    "levels4": dict(B=1, Lq=4, nH=8, dh=32, nP=4, shapes=[(8, 8), (4, 4), (2, 2), (1, 1)]),
    "wide": dict(B=1, Lq=2, nH=16, dh=64, nP=8, shapes=[(2, 2), (1, 1)]),
}


@pytest.mark.parametrize("case", sorted(TAKEN))
def test_forward_checks_take_what_the_kernel_takes(case):
    value, shapes, loc, aw = _forward_inputs(**TAKEN[case])
    assert value.is_contiguous()
    MSDAForward._check(value, shapes, loc, aw)


@pytest.mark.parametrize("case", ["dh12", "offset", "odd_offset", "levels4"])
def test_perquery_checks_take_what_the_kernel_takes(case):
    value, shapes, loc, aw = _forward_inputs(**TAKEN[case])
    B, Lq, nH, nL, nP, _ = loc.shape
    vflat = value.view(B, -1, nH, value.shape[-1] // nH).transpose(1, 2)
    offset = TAKEN[case].get("offset", 0)
    vflat = torch.zeros(vflat.numel() + offset, dtype=vflat.dtype)[offset:].view(vflat.shape)
    MSDAPerQuery._check(vflat, shapes, torch.zeros(B, nH, Lq, nL * nP * 2),
                        torch.zeros(B, nH, Lq, nL * nP))


# ---- kernel #5 (csrc/msda_ablate.cu): a thread owns `vec` channels of one
# point; lanes = dh / vec threads share a point

L_LEVELS = [(80, 80), (40, 40), (20, 20)]
P_L = 1080 * 4            # points of one (image, head) at the L eval shapes


@pytest.mark.parametrize("size,dh,itemsize,want", [
    ("L", 32, 2, (8, 4, 64)),
    ("L rows", 32, 4, (4, 8, 32)),       # no_cexp's point pass on float32 row sums
    ("N", 16, 2, (8, 2, 128)),
    ("X", 48, 2, (8, 6, 42)),
    ("dh 12", 12, 2, (4, 3, 85)),         # 24 bytes: 8-byte loads
    ("dh 12 rows", 12, 4, (4, 3, 85)),
    ("dh 7", 7, 2, (1, 7, 36)),
])
def test_point_plan_at_model_shapes(size, dh, itemsize, want):
    plan = point_plan(dh, itemsize, [BASE] * 3, P_L, 256)
    assert (plan.vec, plan.lanes, plan.slots) == want
    assert plan.lanes * plan.vec == dh
    assert plan.slots * plan.lanes <= BLOCK_THREADS < (plan.slots + 1) * plan.lanes


@pytest.mark.parametrize("level,offset,vec", [(0, 2, 1), (1, 4, 2), (2, 8, 4), (2, 16, 8),
                                              (1, 6, 1), (0, 32, 8)])
def test_point_plan_takes_the_width_every_level_allows(level, offset, vec):
    # one level's map `offset` bytes past a 16-byte boundary narrows them all
    ptrs = [BASE] * 3
    ptrs[level] += offset
    plan = point_plan(32, 2, ptrs, P_L, 256)
    assert plan.vec == vec and plan.lanes == 32 // vec


@pytest.mark.parametrize("P,tile,blocks,last", [(P_L, 256, 17, 224), (P_L, 1024, 5, 224),
                                                (P_L, 37, 117, 28), (37, 37, 1, 37),
                                                (540, 1024, 1, 540), (1, 256, 1, 1)])
def test_point_plan_covers_a_ragged_last_tile(P, tile, blocks, last):
    plan = point_plan(32, 2, [BASE], P, tile)
    assert plan.blocks == blocks
    assert P - (plan.blocks - 1) * tile == last      # the points of the last block
    # a block takes `slots` points a round; the rounds cover its tile
    assert -(-min(tile, P) // plan.slots) * plan.slots >= min(tile, P)


def test_point_plan_raises_past_a_block():
    assert point_plan(256, 2, [BASE + 2], P_L, 256).lanes == BLOCK_THREADS
    with pytest.raises(ValueError):
        point_plan(257, 2, [BASE], P_L, 256)      # odd: one channel a thread
    assert point_plan(2048, 2, [BASE], P_L, 256).lanes == BLOCK_THREADS


@pytest.mark.parametrize("mode", MODES)
def test_ablate_plan_by_mode(mode):
    values = [torch.zeros(2, 8, H, W * 32, dtype=torch.bfloat16) for H, W in L_LEVELS]
    plan, row_vec = ablate_plan(mode, values, 32, P_L, 256, rows_ptr=BASE)
    if mode == "no_cexp":       # float32 row sums in the point pass, bf16 maps in the row pass
        assert (plan.vec, plan.lanes, row_vec) == (4, 8, 8)
    else:
        assert (plan.vec, plan.lanes, row_vec) == (8, 4, 0)


@pytest.mark.parametrize("size,shapes,dh,P", [
    ("L", L_LEVELS, 32, P_L),
    ("N", [(40, 40), (20, 20)], 16, 1080 * 6),
    ("X", L_LEVELS, 48, P_L),
])
def test_colsin_plan_is_the_point_plan(size, shapes, dh, P):
    # kernel #3 is launched as kernel #5 `full`: 16-byte loads at the model shapes
    _, values = _point_inputs(1, 1, 1, shapes, dh)
    plan = MSDAColsin.plan(values, dh, P)
    assert plan == point_plan(dh, 2, [v.data_ptr() for v in values], P, 256)
    assert plan == ablate_plan("full", values, dh, P, 256)[0]
    assert (plan.vec, plan.lanes) == (8, dh // 8)


# ---- kernel #4 (csrc/msda_tpose.cu): the fewest channel groups whose maps
# fit one block's shared memory, two blocks to an SM; each group a block

def _level_bytes(shapes, chans):
    return [W * chans * H * 2 for H, W in shapes]


@pytest.mark.parametrize("size,shapes,dh,P,groups,smem", [
    ("L", L_LEVELS, 32, P_L, 8, 67216),
    ("N", [(40, 40), (20, 20)], 16, 1080 * 6, 1, 64016),
    ("X", L_LEVELS, 48, P_L, 8, 100816),                 # 6 channels a group
    ("test", [(16, 16), (8, 8), (4, 4)], 32, 135 * 4, 1, 21520),
    ("L at 1280 px", [(160, 160), (80, 80), (40, 40)], 32, P_L, 32, 67216),
])
def test_tpose_plan_at_model_shapes(size, shapes, dh, P, groups, smem):
    plan = tpose_plan(shapes, dh, P, [BASE] * len(shapes))
    assert (plan.groups, plan.chans, plan.smem) == (groups, dh // groups, smem)
    assert plan.staged and plan.blocks == 1 and plan.threads == TPOSE_THREADS
    assert plan.bulk == (True,) * len(shapes)
    # the levels lie one after another, 16-byte aligned, after the barrier
    ends = [o + n for o, n in zip(plan.offset, _level_bytes(shapes, plan.chans))]
    assert plan.offset[0] == TPOSE_BARRIER and all(o % 16 == 0 for o in plan.offset)
    assert all(e <= o for e, o in zip(ends, plan.offset[1:])) and ends[-1] <= plan.smem
    # two blocks share an SM; a group of the next divisor up would not fit
    assert 2 * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
    wider = min((d for d in range(plan.chans + 1, dh + 1) if dh % d == 0), default=None)
    if wider:
        assert TPOSE_BARRIER + sum(_level_bytes(shapes, wider)) > TPOSE_BUDGET


@pytest.mark.parametrize("budget,groups", [(SMEM_OPTIN, 1), (21520, 1), (21519, 2),
                                           (10768, 2), (10767, 4), (5392, 4), (3000, 8),
                                           (688, 32)])
def test_tpose_plan_under_a_forced_budget(budget, groups):
    # 672 bytes a channel at the test shapes
    plan = tpose_plan([(16, 16), (8, 8), (4, 4)], 32, 540, [BASE] * 3, budget)
    assert plan.staged and plan.groups == groups and plan.smem <= budget


@pytest.mark.parametrize("shapes,dh,P,budget", [
    ([(16, 16), (8, 8), (4, 4)], 32, 540, 687),           # one channel is 688 bytes
    ([(16, 16), (8, 8), (4, 4)], 32, 37, 0),
    ([(240, 240), (120, 120), (60, 60)], 32, P_L, TPOSE_BUDGET),   # L at 1920 px
    ([(1024, 1024)], 32, 100, TPOSE_BUDGET),
])
def test_tpose_plan_reads_device_memory_where_one_channel_does_not_fit(shapes, dh, P,
                                                                        budget):
    plan = tpose_plan(shapes, dh, P, [BASE] * len(shapes), budget)
    assert not plan.staged and (plan.groups, plan.chans, plan.smem) == (1, dh, 0)
    # blocks along the points, each point one thread
    assert plan.threads % 32 == 0 and plan.threads <= TPOSE_THREADS
    assert (plan.blocks - 1) * plan.threads < P <= plan.blocks * plan.threads


@pytest.mark.parametrize("shapes,dh,offsets,budget,bulk", [
    ([(7, 9), (5, 3)], 12, (0, 0), TPOSE_BUDGET, (False, False)),   # runs of 168, 120 bytes
    ([(8, 9), (5, 3)], 12, (0, 0), TPOSE_BUDGET, (True, False)),    # 192 bytes, 120 bytes
    ([(16, 16), (8, 8)], 32, (2, 0), TPOSE_BUDGET, (False, True)),  # level 0's map 2 bytes in
    ([(16, 16), (8, 8)], 32, (0, 16), TPOSE_BUDGET, (True, True)),
    ([(6, 8)], 12, (0,), 1168, (True,)),                            # 12 channels: 144 bytes
    ([(6, 8)], 12, (0,), 1167, (False,)),                           # 6 channels: 72 bytes
])
def test_tpose_plan_fill_mode(shapes, dh, offsets, budget, bulk):
    plan = tpose_plan(shapes, dh, 100, [BASE + o for o in offsets], budget)
    assert plan.staged and plan.bulk == bulk


def test_tpose_plan_takes_the_fewest_groups_that_fit():
    shapes = [(7, 9), (5, 3), (2, 2)]
    per_channel = sum(_level_bytes(shapes, 1))
    for dh in range(1, 49):
        for budget in range(0, 48 * per_channel, 97):
            plan = tpose_plan(shapes, dh, 50, [BASE] * 3, budget)
            assert plan.groups * plan.chans == dh
            if plan.staged:
                assert plan.smem <= budget
                # every divisor with fewer groups needs more than the budget
                assert all(TPOSE_BARRIER + sum(-(-n // 16) * 16
                                               for n in _level_bytes(shapes, d)) > budget
                           for d in range(plan.chans + 1, dh + 1) if dh % d == 0)
            else:
                assert TPOSE_BARRIER + sum(-(-n // 16) * 16
                                           for n in _level_bytes(shapes, 1)) > budget


# ---- the wrappers of #3, #4 and #5 take what their kernels take

def _point_inputs(B, nH, P, shapes, dh, transposed=False, offset=0):
    pts = [tuple(torch.zeros(B, nH, P) for _ in range(3)) for _ in shapes]
    values = []
    for H, W in shapes:
        dims = (W * dh, H) if transposed else (H, W * dh)
        n = B * nH * dims[0] * dims[1]
        values.append(torch.zeros(n + offset, dtype=torch.bfloat16)[offset:]
                      .view(B, nH, *dims))
    return pts, values


PER_POINT = {
    "dh12": dict(B=1, nH=3, P=111, shapes=[(7, 9), (5, 3)], dh=12),
    "offset": dict(B=2, nH=8, P=540, shapes=[(16, 16), (8, 8), (4, 4)], dh=32, offset=2),
    "levels4": dict(B=1, nH=8, P=60, shapes=[(8, 8), (4, 4), (2, 2), (1, 1)], dh=32),
    "wide": dict(B=1, nH=2, P=8, shapes=[(2, 2), (1, 1)], dh=256, offset=1),
}


@pytest.mark.parametrize("case", sorted(PER_POINT))
def test_per_point_checks_take_what_the_kernels_take(case):
    kw = dict(PER_POINT[case])
    for mode in MODES:
        pts, values = _point_inputs(**kw)
        assert MSDAAblate._check(mode, pts, values, kw["shapes"], 37) == kw["dh"]
    pts, values = _point_inputs(**kw, transposed=True)
    assert MSDATpose._check(pts, values, kw["shapes"]) == kw["dh"]


@pytest.mark.parametrize("case", sorted(PER_POINT))
def test_colsin_checks_take_what_the_kernel_takes(case):
    # dh 256 on a map 2 bytes into its buffer is 256 threads a point, one
    # point a block
    kw = dict(PER_POINT[case])
    pts, values = _point_inputs(**kw)
    cols = column_planes(kw["shapes"], kw["dh"], "cpu")
    assert MSDAColsin._check(pts, values, cols, kw["shapes"], 37) == kw["dh"]
    assert MSDAColsin.plan(values, kw["dh"], kw["P"]).lanes <= BLOCK_THREADS


def test_tpose_plan_struct_carries_the_plan():
    # the by-value struct kernel #4's entry point takes
    from detrpose_tpu_torch.ops.cuda.msda_tpose import _TposePlan
    plan = tpose_plan([(8, 9), (5, 3)], 12, 100, [BASE, BASE], budget=1000)
    c = _TposePlan.of(plan)
    assert not _TposePlan.of(tpose_plan([(8, 9)], 12, 100, [BASE], budget=0)).staged
    assert plan.chans < 12 and plan.bulk == (True, False)
    assert (c.groups, c.chans, c.staged, c.threads, c.blocks, c.smem, c.bulk) == (
        plan.groups, plan.chans, 1, plan.threads, plan.blocks, plan.smem, 1)
    assert list(c.offset)[:2] == list(plan.offset)
