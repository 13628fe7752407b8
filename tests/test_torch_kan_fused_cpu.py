"""The FastKAN basis kernel's host side on the CPU (``ops/cuda/kan.py``):
which path a FastKAN layer takes, that the CPU never opens the kernel's
profiler range, the launch plan, the op's fake, the u table, the padded
``out_linear`` weight kept per version, and the kernel's premise: for every bf16 u in [0, G-1] and every centre, the three
bf16 pieces of the float32 basis value sum to it exactly.

The kernel itself runs only on the card (``tests/test_torch_kan_fused.py``).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detrpose_tpu_torch.models import layers
from detrpose_tpu_torch.models.layers import FastKANLayer
from detrpose_tpu_torch.ops.cuda.kan import (KAN_COLS, KAN_ROWS, SPAN, basis_u,
                                             gaussian_basis, kan_basis, kan_basis_plain,
                                             kan_path, kan_plan, padded, padded_weight,
                                             sigma_reciprocal, u_table)
from detrpose_tpu_torch.ops.cuda.msda import SMEM_OPTIN

BF16, F32 = torch.bfloat16, torch.float32
CELL = 32 * 60 * 18          # the cell's decoder tokens: bs 32, 60 queries x 18


@pytest.mark.parametrize("device, dtypes, grad, requires, grid, path", [
    ("cpu", (BF16, BF16), False, (False, False), 3, "plain"),
    ("cuda", (F32, F32), False, (False, False), 3, "plain"),          # a float32 model
    ("cuda", (BF16, BF16), True, (True, True), 3, "plain"),           # grad mode on, training
    ("cuda", (BF16, BF16), True, (False, True), 3, "plain"),          # a coefficient wants grad
    ("cuda", (BF16, BF16), True, (False, False), 3, "kernel"),        # nothing requires grad
    ("cuda", (BF16, BF16), False, (False, True), 3, "kernel"),        # serving: grad mode off
    ("cuda", (BF16, BF16), False, (False, False), 1, "plain"),        # one centre
    ("cuda", (BF16, BF16), True, (False, False, True), 3, "plain"),   # out_linear wants grad
], ids=["cpu", "float32", "grad_mode", "coeff_requires_grad", "no_requires_grad", "serving",
        "one_centre", "out_linear_requires_grad"])
def test_the_path_a_layer_takes(device, dtypes, grad, requires, grid, path):
    assert kan_path(device, dtypes, grad, requires, grid) == path


def _ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_cpu_never_opens_the_kernels_range(dtype):
    torch.manual_seed(0)
    layer = FastKANLayer(16, 24, grid_size=3).to(dtype)
    x = torch.randn(3, 5, 16).to(dtype)
    with torch.no_grad():
        names = _ranges(lambda: layer(x))
    assert SPAN not in names


def test_the_kernel_path_opens_one_range_a_call(monkeypatch):
    """The layer's kernel path, run on the CPU by forcing the predicate: one
    ``kan.fused`` range a call around the op, which on CPU tensors is the
    plain version, so the output is the plain path's."""
    torch.manual_seed(0)
    layer = FastKANLayer(16, 24, grid_size=3).to(BF16)
    x = torch.randn(3, 5, 16).to(BF16)
    with torch.no_grad():
        plain = layer(x)
        monkeypatch.setattr(layers, "kan_path", lambda *args: "kernel")
        names = _ranges(lambda: layer(x))
        fused = layer(x)
    assert names.count(SPAN) == 1
    assert torch.equal(fused, plain)


def test_the_layer_asks_the_predicate_about_every_parameter(monkeypatch):
    """A layer whose coefficients are frozen and whose ``out_linear`` trains
    wants a gradient: the predicate sees its weight, and the plain path runs."""
    seen = []
    monkeypatch.setattr(layers, "kan_path",
                        lambda *args: seen.append(args) or kan_path("cuda", *args[1:]))
    layer = FastKANLayer(16, 24, grid_size=3).to(BF16)
    for p in layer.parameters():
        p.requires_grad_(p is layer.out_linear.weight)
    y = layer(torch.randn(3, 5, 16).to(BF16))
    assert seen and seen[0][0] == "cpu" and kan_path("cuda", *seen[0][1:]) == "plain"
    y.float().sum().backward()
    assert layer.out_linear.weight.grad is not None


def test_the_padded_weight_is_made_once_a_version():
    torch.manual_seed(0)
    linear = torch.nn.Linear(13, 6).to(BF16)
    w = padded_weight(linear.weight)
    assert w.shape == (6, padded(13)) and not w[:, 13:].any()
    assert torch.equal(w[:, :13], linear.weight.detach()) and not w.requires_grad
    assert padded_weight(linear.weight) is w                  # kept
    linear.load_state_dict({"weight": linear.weight.detach() * 2, "bias": linear.bias.detach()})
    reloaded = padded_weight(linear.weight)                   # a new version: made again
    assert reloaded is not w and torch.equal(reloaded[:, :13], linear.weight.detach())
    linear.float()                                            # a cast: new storage
    cast = padded_weight(linear.weight)
    assert cast.dtype == F32 and torch.equal(cast[:, :13], linear.weight.detach())
    assert padded_weight(linear.weight) is cast


def _bf16_in(lo, hi):
    """Every bf16 value in [lo, hi], as float32."""
    bits = torch.arange(0, 2 ** 16, dtype=torch.int32).to(torch.int16)
    v = bits.view(BF16).float()
    return v[(v >= lo) & (v <= hi)]


@pytest.mark.parametrize("grid", [2, 3, 5, 8])
def test_three_pieces_sum_to_the_basis_for_every_u(grid):
    """The kernel's split (csrc/kan_basis.cu::split): hi = bf16(b), mid =
    bf16(b - hi), lo = bf16(b - hi - mid), each rounded to nearest."""
    u = _bf16_in(0.0, grid - 1)
    b = gaussian_basis(u.to(BF16), grid, 1.0)          # float32, (n, G)
    assert b.dtype == F32 and b.min() >= np.exp(-(grid - 1) ** 2) * (1 - 1e-6)
    hi = b.to(BF16)
    mid = (b - hi.float()).to(BF16)
    lo = (b - hi.float() - mid.float()).to(BF16)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, b.double())


@pytest.mark.parametrize("grid", [3, 5])
def test_the_u_table_is_u_of_every_bf16_value_by_its_bits(grid):
    table = u_table(grid, torch.device("cpu"))
    x = torch.randn(4096).mul(3).to(BF16)
    x[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0])
    looked_up = table[x.view(torch.int16).long() & 0xFFFF]
    want = basis_u(x, grid)
    assert torch.equal(looked_up.view(torch.int16), want.view(torch.int16))
    finite = table[~torch.isnan(table)].float()
    assert finite.min() >= 0 and finite.max() <= grid - 1


@pytest.mark.parametrize("grid", [2, 3, 5, 21])
def test_the_plan_fits_a_block(grid):
    for D, r in ((256, 129), (1024, 513)):     # the cell's kan1 and kan2
        plan = kan_plan(CELL, D, grid, r, 132)
        assert plan.smem <= SMEM_OPTIN and plan.xdim % 16 == 8
        assert plan.xdim >= 63 // grid + 9      # every input a chunk reaches, from a multiple of 8
        assert plan.tiles == (CELL // KAN_ROWS) * -(-r // KAN_COLS) and plan.grid == 132
    assert kan_plan(CELL, 1024, 3, 513, 132).tiles == 810   # 270 row tiles x 3


def test_the_plan_refuses_one_centre():
    with pytest.raises(ValueError):
        kan_plan(CELL, 1024, 1, 513, 132)


def test_sigma_reciprocal_is_the_float32_reciprocal():
    for sigma in (1.0, 0.7, 2.5):
        assert sigma_reciprocal(sigma) == float(np.float32(1.0) / np.float32(sigma + 1e-12))
    assert sigma_reciprocal(1.0) == 1.0


def test_the_op_has_a_fake():
    xn = torch.empty(300, 64, device="meta", dtype=BF16)
    coeffs = torch.empty(33, 64, 3, device="meta", dtype=BF16)
    out = torch.ops.detrpose_tpu_torch.kan_basis(xn, coeffs, 1.0)
    assert out.shape == (300, 40) and out.dtype == BF16     # rows padded to 16 bytes


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_the_wrapper_on_cpu_tensors_is_the_plain_version(dtype):
    torch.manual_seed(0)
    xn = torch.randn(40, 24).to(BF16)
    coeffs = (torch.randn(13, 24, 3) * 0.1).to(BF16)
    launches = kan_basis.launches
    got = kan_basis(xn, coeffs, 1.0, out_dtype=dtype)
    assert got.shape == (40, padded(13)) == (40, 16)
    assert torch.equal(got[:, :13], kan_basis_plain(xn, coeffs, 1.0).to(dtype))
    assert not got[:, 13:].any()
    assert kan_basis.launches == launches
