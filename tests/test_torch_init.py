"""The port's initial weights against JAX ``model.init``, leaf by leaf.

For each configuration, JAX ``model.init(PRNGKey(s))`` and the port's
``build_model(..., generator=torch.Generator().manual_seed(s))`` for seeds
0, 1 and 2, on the CPU; JAX's variables go through the weight key map
(``utils/convert.py::from_jax_variables``: kernels transposed, q/k/v packed,
the scanned decoder split), so each port leaf meets its JAX leaf in the
port's layout. The configurations here: N and S for COCO (17 keypoints)
and CrowdPose (14); tests/test_torch_init_variants.py takes L and the
variants through the same checks.

A leaf that is the same for JAX's three seeds (zeros, ones, the class prior,
the circle bias, 2.0, the BatchNorm statistics) must be the same for the
port's three and equal JAX's exactly. Any other leaf must differ between the
port's seeds too, and, pooled over the 3 seeds:
  * where JAX's values stay within flax's truncation bound 2 / 0.8796 /
    sqrt(fan_in) (lecun-normal), the port's must too;
  * with 1024 entries or more, std * sqrt(fan_in) within 10% of JAX's, and a
    two-sample KS test of the values against JAX's (the first 2^17 of the
    pooled values on each side, where there are more: the entries of a leaf
    are i.i.d.);
and a two-sample KS test of the normalised values x * sqrt(fan_in) of every
such leaf, pooled, against JAX's has p > 1e-3. The leaf-by-leaf KS tests
hold the family of a model's leaves to the same 1e-3 (Bonferroni: each
leaf's p above 1e-3 / the number of leaves tested): with hundreds of leaves
a model, a threshold of 1e-3 a leaf would fail on chance alone, as two of
L's did for JAX's seeds against the port's. fan_in is ``w[0].numel()`` of
the port's weight (flax's: kh * kw * in / groups for a conv, d for each of
the packed in-projection's three blocks).

Then the two invariants the zero heads give at init: every ``Gate`` opens at
exactly 0.5, and every ``LQE`` head is the identity on the scores.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models.decoder import LQE
from detrpose_tpu_torch.models.detrpose import TRUNCATED_STD
from detrpose_tpu_torch.models.layers import Gate
from detrpose_tpu_torch.utils.convert import drop_derived, from_jax_variables

torch.set_num_threads(2)
SEEDS = (0, 1, 2)
HW = 128
MIN_ENTRIES = 1024
P_FAMILY = 1e-3
KS_ENTRIES = 1 << 17   # the KS tests take a leaf's first entries (i.i.d.)

CASES = {
    "n_coco": ("n", {}),
    "n_crowdpose": ("n", dict(num_body_points=14)),
    "s_coco": ("s", {}),
    "s_crowdpose": ("s", dict(num_body_points=14)),
}


def draw(size, flags):
    """({key: [JAX leaf per seed]}, {key: [port leaf per seed]}, {key: fan_in})."""
    jm = jax_build_model(jax_model_config(size, **flags))
    init = jax.jit(lambda r: jm.init(r, jnp.zeros((1, HW, HW, 3)), train=False))
    jax_sd, port_sd, fan_in = {}, {}, {}
    for s in SEEDS:
        variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(s)))
        for k, v in from_jax_variables(variables).items():
            jax_sd.setdefault(k, []).append(v)
        port = build_model(model_config(size, **flags), device="cpu",
                           generator=torch.Generator().manual_seed(s))
        for k, v in drop_derived(port.state_dict()).items():
            port_sd.setdefault(k, []).append(v.detach().clone())
    for k, v in port_sd.items():
        fan_in[k] = v[0][0].numel() if v[0].dim() > 1 else v[0].numel()
    return jax_sd, port_sd, fan_in


def constant(leaves):
    return all(torch.equal(leaves[0], t) for t in leaves[1:])


def check_fixed_leaves(jax_sd, port_sd, fan_in):
    assert set(jax_sd) == set(port_sd)
    fixed = [k for k, v in jax_sd.items() if constant(v)]
    assert fixed
    for k in fixed:
        assert constant(port_sd[k]), f"{k}: JAX's is fixed, the port draws it"
        assert port_sd[k][0].dtype == jax_sd[k][0].dtype
        assert torch.equal(port_sd[k][0], jax_sd[k][0]), (
            f"{k}: max|port - JAX| {(port_sd[k][0] - jax_sd[k][0]).abs().max():.3e}")


def check_random_leaves(jax_sd, port_sd, fan_in):
    drawn = [k for k, v in jax_sd.items() if not constant(v)]
    assert drawn
    bad, tested, pooled = [], {}, ([], [])
    for k in drawn:
        if constant(port_sd[k]):
            bad.append((k, "the port's is fixed"))
            continue
        want = torch.cat([t.flatten() for t in jax_sd[k]]).double().numpy()
        got = torch.cat([t.flatten() for t in port_sd[k]]).double().numpy()
        sample = (got[:KS_ENTRIES], want[:KS_ENTRIES])
        bound = 2.0 / TRUNCATED_STD / np.sqrt(fan_in[k]) * (1 + 1e-6)
        if np.abs(want).max() <= bound and np.abs(got).max() > bound:
            bad.append((k, f"max|x| {np.abs(got).max():.4g} past the bound {bound:.4g}"))
        if want.size < MIN_ENTRIES:
            continue
        scale = np.sqrt(fan_in[k])
        if not 0.9 <= got.std() / want.std() <= 1.1:
            bad.append((k, f"std * sqrt(fan_in) {got.std() * scale:.4f} against JAX's "
                           f"{want.std() * scale:.4f}"))
        tested[k] = stats.ks_2samp(*sample).pvalue
        pooled[0].append(sample[0] * scale)
        pooled[1].append(sample[1] * scale)
    assert tested
    bad += [(k, f"KS p {p:.3g} of {len(tested)} leaves") for k, p in tested.items()
            if not p > P_FAMILY / len(tested)]
    p = stats.ks_2samp(np.concatenate(pooled[0]), np.concatenate(pooled[1])).pvalue
    if not p > P_FAMILY:
        bad.append(("pooled x * sqrt(fan_in)", f"KS p {p:.3g}"))
    assert not bad, bad


@pytest.fixture(scope="module", params=list(CASES))
def draws(request):
    """One configuration's draws; pytest runs a configuration's tests together."""
    return draw(*CASES[request.param])


def test_fixed_leaves_equal_jax(draws):
    check_fixed_leaves(*draws)


def test_random_leaves_match_jax_distribution(draws):
    check_random_leaves(*draws)


@pytest.mark.parametrize("size", ["n", "l"])
def test_lecun_scale(size):
    """std * sqrt(fan_in) is flax's 1 on the wide lecun leaves (the FFN's
    first layer, the encoder's in-projection, a backbone 1x1 and depthwise
    conv), within 3%."""
    port = build_model(model_config(size), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    sd = port.state_dict()
    for k in ("encoder.encoder.0.layers.0.linear1.weight",
              "encoder.encoder.0.layers.0.self_attn.in_proj_weight",
              "transformer.decoder.layers.0.linear1.weight",
              "backbone.stages.2.blocks.0.layers.0.conv1.conv.weight",
              "backbone.stages.2.blocks.0.layers.0.conv2.conv.weight"):
        x = sd[k].double()
        assert abs(x.std().item() * np.sqrt(x[0].numel()) - 1.0) < 0.03, k


@pytest.mark.parametrize("case", ["n_coco", "s_crowdpose"])
def test_gate_opens_at_half_and_lqe_is_the_identity(case):
    size, flags = CASES[case]
    port = build_model(model_config(size, **flags), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    gates = [m for m in port.modules() if isinstance(m, Gate)]
    lqes = [m for m in port.modules() if isinstance(m, LQE)]
    assert gates and lqes
    d = gates[0].norm.normalized_shape[0]
    x1, x2 = torch.randn(2, 5, d, generator=g), torch.randn(2, 5, d, generator=g)
    with torch.no_grad():
        for m in gates:
            opened = torch.sigmoid(m.gate(torch.cat([x1, x2], dim=-1)))
            assert torch.equal(opened, torch.full_like(opened, 0.5))
            assert torch.equal(m(x1, x2), m.norm(0.5 * x1 + 0.5 * x2))
        K = model_config(size, **flags).num_body_points
        scores = torch.randn(2, 7, 2, generator=g)
        poses = torch.rand(2, 7, K, 2, generator=g)
        feat = torch.randn(2, 256, 9, 11, generator=g)
        for m in lqes:
            assert torch.equal(m(scores, poses, feat), scores)
