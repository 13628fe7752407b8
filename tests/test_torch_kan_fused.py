"""The FastKAN basis kernel (``csrc/kan_basis.cu``) against its plain version,
on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports torch only, so on a machine with a
card and no JAX it runs without the suite's conftest:

  python -m pytest --noconftest -m gpu tests/test_torch_kan_fused.py

Shapes: the cell's ``kan1`` (N 34,560 tokens, D 256, r 129) and ``kan2``
(D 1024, r 513) with G 3, a ragged N (not a multiple of the 128-row tile),
G 5 with an odd D (rows and coefficients off TMA's 16-byte rule, so the
wrapper pads them), a sigma other than 1, and D 64 on two seeds: with
three chunks of K the sums are short, so the tensor cores' truncating adds
weigh most against the float32 product's there.

The kernel's rows are padded to a multiple of 8 outputs with zeros, for the
aligned product that reads them next.

Tolerances. The bf16 output agrees with the plain path's within one bf16
ulp of each value, beyond the float32 sums' own error: both sides round a
float32 sum of the same terms taken in another order, and where the sum
cancels to near zero that order moves it by up to the plain product's own
distance from a float64 product (measured here, ``max|fp32 - fp64|``).
Before the cast, the kernel's float32 sums are at least as close to the
float64 product of the same basis as cuBLAS's float32 product is, within a
factor of 2, in their largest and their rms error: the guard that the three
bf16 passes did not lower the precision.
"""
import pytest
import torch

from detrpose_tpu_torch.models.layers import FastKANLayer
from detrpose_tpu_torch.ops.cuda.kan import (basis_u, gaussian_basis, kan_basis, kan_basis_plain,
                                             padded, padded_weight)

CELL = 32 * 60 * 18


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain product in full float32
    return torch.device("cuda")


def _inputs(N, D, G, r, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xn = torch.randn(N, D, generator=g, device="cuda").bfloat16()
    coeffs = (torch.randn(r, D, G, generator=g, device="cuda") / (D * G) ** 0.5).bfloat16()
    return xn, coeffs


def _bf16_ulp(v):
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("N, D, G, r, sigma, seed", [
    (CELL, 256, 3, 129, 1.0, 0),      # kan1
    (CELL, 1024, 3, 513, 1.0, 0),     # kan2
    (1000, 256, 3, 129, 1.0, 0),      # a ragged row tile
    (777, 129, 5, 65, 1.0, 0),        # G 5, odd D: padded rows and coefficients
    (500, 64, 3, 33, 0.7, 0),         # another sigma
    (CELL, 64, 3, 129, 1.0, 1),       # D 64: three chunks of K
    (CELL, 64, 3, 129, 1.0, 2),
], ids=["kan1", "kan2", "ragged_n", "g5_odd_d", "sigma", "d64_seed1", "d64_seed2"])
def test_the_kernel_against_the_plain_path(cuda, N, D, G, r, sigma, seed):
    xn, coeffs = _inputs(N, D, G, r, seed)
    launches = kan_basis.launches
    got = kan_basis(xn, coeffs, sigma)
    sums = kan_basis(xn, coeffs, sigma, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert kan_basis.launches == launches + 2
    assert got.dtype == torch.bfloat16 and sums.dtype == torch.float32
    assert got.shape == sums.shape == (N, padded(r))
    assert not got[:, r:].any() and not sums[:, r:].any()     # the rows' padding
    got, sums = got[:, :r], sums[:, :r]

    plain32 = kan_basis_plain(xn, coeffs, sigma)
    basis = gaussian_basis(basis_u(xn, G), G, sigma).reshape(N, D * G)
    exact = basis.double() @ coeffs.reshape(r, D * G).double().T
    del basis
    err_k = (sums.double() - exact).abs()
    err_c = (plain32.double() - exact).abs()
    rms = lambda e: e.pow(2).mean().sqrt().item()
    assert err_k.max().item() <= 2 * err_c.max().item(), (err_k.max(), err_c.max())
    assert rms(err_k) <= 2 * rms(err_c), (rms(err_k), rms(err_c))

    plain = plain32.bfloat16()
    diff = (got.float() - plain.float()).abs()
    ulp = torch.maximum(_bf16_ulp(got), _bf16_ulp(plain))
    assert (diff <= ulp + err_c.max().item()).all(), diff.max()
    assert (got.float() == sums.bfloat16().float()).all()


@pytest.mark.gpu
def test_a_layer_that_needs_a_gradient_takes_the_plain_path(cuda):
    torch.manual_seed(0)
    layer = FastKANLayer(64, 96, grid_size=3).to(cuda, torch.bfloat16)
    x = torch.randn(4, 50, 64, device=cuda).bfloat16()
    launches = kan_basis.launches
    y = layer(x.requires_grad_(True))
    assert kan_basis.launches == launches and y.grad_fn is not None
    y.float().sum().backward()
    assert x.grad is not None and layer.coeffs.grad is not None
    with torch.no_grad():
        served = layer(x)
    assert kan_basis.launches == launches + 1
    assert (served.float() - y.detach().float()).abs().max().item() <= 2e-2 * y.abs().max().item()


@pytest.mark.gpu
def test_a_served_layer_pads_its_weight_once(cuda):
    torch.manual_seed(0)
    layer = FastKANLayer(64, 96, grid_size=3).to(cuda, torch.bfloat16)
    x = torch.randn(4, 50, 64, device=cuda).bfloat16()
    launches = kan_basis.launches
    with torch.no_grad():
        first = layer(x)
        w = padded_weight(layer.out_linear.weight)
        again = layer(x)
    assert kan_basis.launches == launches + 2
    assert padded_weight(layer.out_linear.weight) is w and w.shape == (96, padded(33))
    assert torch.equal(first, again)
