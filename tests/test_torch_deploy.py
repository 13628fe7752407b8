"""The port's deploy re-parameterisation against the JAX package, on the CPU.

``detrpose_tpu_torch/utils/deploy.py::fuse_for_deploy`` works on the port's
state_dict (OIHW), the JAX one on the flax tree (HWIO). Both start from the
same seeded numpy variables (tests/test_torch_models.py::random_variables:
BatchNorm means N(0, 0.1), variances U(0.5, 1.5), scales 1 + N(0, 0.1), so
every fold is non-trivial). Tolerances: fused leaves agree to 1e-6 relative
to each leaf's scale (float32 folds in another order); the deploy-form model
agrees with the JAX deploy form and with the port's train form to 1e-4
absolute on logits and normalized keypoints at 160 px, with the selection
head scaled by 50 so the top-60 order is well defined (tests/test_torch_e2e.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.utils.convert import convert_state_dict
from detrpose_tpu.utils.deploy import fuse_for_deploy as jax_fuse_for_deploy

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.utils.convert import from_jax_variables
from detrpose_tpu_torch.utils.deploy import fuse_for_deploy

from test_torch_e2e import HW, _weights
from test_torch_models import random_variables

torch.set_num_threads(2)


def _template(size, deploy):
    model = jax_build_model(jax_model_config(size), deploy=deploy)
    return model, jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))


@pytest.mark.parametrize("size", ["n", "s"])
def test_fuse_matches_jax(size):
    variables = random_variables(_template(size, False)[1], seed=20)
    got = fuse_for_deploy(from_jax_variables(variables))
    want = from_jax_variables(jax_fuse_for_deploy(jax.tree.map(np.asarray, variables)))
    assert sorted(got) == sorted(want)
    assert any(k.endswith("conv_bn_fused.weight") for k in got)
    assert any(".bottlenecks.0.conv.bias" in k for k in got)
    assert not any(k.startswith("encoder.") and k.endswith("norm.running_mean")
                   and (".cv1." in k or ".cv4." in k) for k in got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        assert (g - w).abs().max().item() <= 1e-6 * max(w.abs().max().item(), 1e-6), k


def test_deploy_form_carries_from_jax_and_round_trips():
    # a JAX deploy-form tree (conv_bn_fused, the biased VGG conv) loads
    # strictly into the deploy-form module, and converts back bit for bit
    _, template = _template("s", True)
    fused = jax_fuse_for_deploy(jax.tree.map(
        np.asarray, random_variables(_template("s", False)[1], seed=21)))
    port = build_model(model_config("s"), deploy=True, device="cpu")
    port.load_state_dict(from_jax_variables(fused), strict=True)
    back = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                              dict(template))
    flat_a = jax.tree_util.tree_leaves_with_path(fused)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


@pytest.mark.parametrize("size", ["n", "s"])
def test_deploy_model_parity(size):
    _, variables = _weights(size, seed=22)
    jdep = jax_build_model(jax_model_config(size), deploy=True)
    fused = jax_fuse_for_deploy(jax.tree.map(np.asarray, variables))
    x = np.random.default_rng(23).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    out_j = jax.jit(lambda v, im: jdep.apply(v, im, train=False))(fused, jnp.asarray(x))

    train = build_model(model_config(size), device="cpu")
    train.load_state_dict(from_jax_variables(variables), strict=True)
    deploy = build_model(model_config(size), deploy=True, device="cpu")
    deploy.load_state_dict(fuse_for_deploy(train.state_dict()), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        out_d, out_t = deploy(xt), train(xt)
    for k in ("pred_logits", "pred_keypoints"):
        np.testing.assert_allclose(out_d[k].numpy(), np.asarray(out_j[k]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(out_d[k].numpy(), out_t[k].numpy(), rtol=0, atol=1e-4)
