"""The launch plan of kernels #1 and #2 (``ops/cuda/msda.py::gather_plan``)
and their wrappers' input checks, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py); the
plan is plain Python: how many channels each thread loads (16 bytes where
the head width and the value map's address allow it, else 8, 4 or one
element), how many threads a row takes, and the grid. The checks must take
every input the kernels take, the narrow and misaligned ones included.
"""
import pytest
import torch

from detrpose_tpu_torch.ops.cuda.msda import BLOCK_THREADS, MSDAForward, gather_plan
from detrpose_tpu_torch.ops.cuda.msda_perquery import MSDAPerQuery

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
