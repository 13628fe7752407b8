"""The reference's model variants end to end in the port against the JAX package.

Whole models at 160 px, batch 2, float32, against eager JAX ``apply``
(1e-4 absolute on logits and normalized keypoints, as
tests/test_torch_e2e.py): N with grouped offsets and modulation, with grid
attention and its offsets unfused, with global context and region sampling,
with the FastKAN FFN; N with energy refinement by the energy's gradient
through ``tools/infer.py::Pipeline`` (whose call runs under
``torch.no_grad()``; the descent takes its gradient under
``torch.enable_grad()``), against JAX's in-graph resize and ``postprocess``;
and S with the ResNet-50 backbone (N's two levels do not take the ResNet's
three maps in JAX either). Weights are the seeded numpy draw of
tests/test_torch_models.py with the selection head scaled by 50. The
default N is also held stage by stage: the backbone's maps, the encoder's
maps (``model.backbone.apply`` and ``model.encoder.apply``), the full
forward and the postprocessed detections.

The energy training step is in tests/test_torch_variants_train.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.models.postprocess import postprocess as jax_postprocess

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models import postprocess
from detrpose_tpu_torch.tools.infer import Pipeline
from detrpose_tpu_torch.utils.convert import from_jax_variables

from test_torch_e2e import _check_decoded
from test_torch_models import random_variables

torch.set_num_threads(2)
HW = 160

VARIANTS = {
    "grouped2_mod": ("n", dict(use_grouped_offsets=True, num_groups=2, use_modulation=True)),
    "grid16_offsets_unfused": ("n", dict(use_grid_attention=True, grid_num_points=16,
                                         use_grid_offsets=True, use_grid_fusion=False)),
    "global_region3": ("n", dict(use_global_context=True, use_region_sampling=True,
                                 region_kernel_size=3)),
    "kan": ("n", dict(use_kan=True, kan_grid=3)),
    "resnet50": ("s", dict(backbone_name="resnet50")),
}


def _weights(size, flags, seed=10):
    jm = jax_build_model(jax_model_config(size, **flags))
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = random_variables(template, seed=seed)
    head = variables["params"]["transformer"]["enc_out_class_embed"]
    head["kernel"] = head["kernel"] * 50.0
    return jm, variables


def _port(size, flags, variables):
    port = build_model(model_config(size, **flags), device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_model_matches_jax(name):
    size, flags = VARIANTS[name]
    jm, variables = _weights(size, flags)
    x = np.random.default_rng(11).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    port = _port(size, flags, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ("pred_logits", "pred_keypoints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4, err_msg=what)


def test_stages_match_jax():
    jm, v = _weights("n", {})
    port = _port("n", {}, v).eval()
    x = np.random.default_rng(11).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    sizes = np.array([[640, 480], [333, 500]], np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    feats = jm.backbone.apply({"params": v["params"]["backbone"],
                               "batch_stats": v["batch_stats"]["backbone"]}, xj, False)
    enc_vars = {"params": v["params"]["encoder"]}
    if "encoder" in v.get("batch_stats", {}):
        enc_vars["batch_stats"] = v["batch_stats"]["encoder"]
    enc = jm.encoder.apply(enc_vars, feats, False)
    full = jm.apply(v, xj, train=False)
    with torch.no_grad():
        got_feats = port.backbone(xt)
        got = {"backbone": got_feats, "backbone+encoder": port.encoder(got_feats)}
        got_full = port(xt)
        decoded = postprocess(got_full, torch.from_numpy(sizes), num_body_points=17)
    for name, want in (("backbone", feats), ("backbone+encoder", enc)):
        assert len(got[name]) == len(want)
        for i, (g, w) in enumerate(zip(got[name], want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w, f"{name} map {i}")
    for k in ("pred_logits", "pred_keypoints"):
        _close(got_full[k].numpy(), full[k], k)
    _check_decoded(decoded, jax_postprocess(full, jnp.asarray(sizes)))


def test_energy_refinement_through_the_pipeline():
    flags = dict(use_energy_refinement=True, energy_steps=2, grad_energy=True,
                 energy_decrease_weight=0.01)
    jm, variables = _weights("n", flags, seed=12)
    # a step that moves the keypoints by ~1e-2: the energy's gradient is a
    # mean over 2 x 60 x 18 tokens
    variables["params"]["transformer"]["decoder"]["energy_step_size"] = np.full(
        (1,), 1e3, np.float32)
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (200, 180, 3)).astype(np.uint8)
    x = jax.image.resize(jnp.asarray(img, jnp.float32) / 255.0, (HW, HW, 3), "bilinear")
    out_j = jm.apply(variables, x[None], train=False)
    want = jax_postprocess(out_j, jnp.asarray([[180.0, 200.0]]))
    run = Pipeline(_port("n", flags, variables), HW, 17, torch.float32, torch.device("cpu"))
    _check_decoded(run(img, (180, 200)), want)
    # the refinement moves the outputs: without its steps they differ
    unrefined = Pipeline(_port("n", dict(flags, energy_steps=0), variables), HW, 17,
                         torch.float32, torch.device("cpu"))
    assert (run(img, (180, 200))[2] - unrefined(img, (180, 200))[2]).abs().max() > 1e-1
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        run.model(torch.zeros(1, 3, HW, HW))
