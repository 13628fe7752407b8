"""The port's initial weights against JAX ``model.init`` for L and the
model variants: L with 2 decoder layers (HGNetv2-B4, the hybrid encoder's
AIFI layer, the decoder), and N with the FastKAN FFN (``out_linear``), with
energy refinement (``energy_expand``, ``energy_reduce``, the step size),
and with grouped offsets, modulation, the global gate and the fused grid
branch; S with the ResNet-50 backbone (flax's default conv init, not the
torch reference's kaiming). The checks are tests/test_torch_init.py's.
"""
import pytest

from test_torch_init import check_fixed_leaves, check_random_leaves, draw

CASES = {
    "l_2_layers": ("l", dict(num_decoder_layers=2)),
    "n_kan": ("n", dict(use_kan=True, kan_grid=3)),
    "n_energy": ("n", dict(use_energy_refinement=True, energy_steps=2)),
    "n_grouped_mod_global_grid": ("n", dict(
        use_grouped_offsets=True, num_groups=2, use_modulation=True,
        use_global_context=True, use_grid_attention=True, grid_num_points=4,
        use_grid_offsets=True, use_grid_fusion=True)),
    "s_resnet50": ("s", dict(backbone_name="resnet50")),
}


@pytest.fixture(scope="module", params=list(CASES))
def draws(request):
    """One configuration's draws; pytest runs a configuration's tests together."""
    return draw(*CASES[request.param])


def test_fixed_leaves_equal_jax(draws):
    check_fixed_leaves(*draws)


def test_random_leaves_match_jax_distribution(draws):
    check_random_leaves(*draws)
