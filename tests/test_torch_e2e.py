"""The port's serving slice end to end against the JAX package, on the CPU.

N (2 levels, 6 points, dh 16), S (3 levels, 4 points, dh 32: L's decoder) and
M (4 decoder layers, B2 backbone) at 160 px, batch 2, float32, and N with 14
keypoints (CrowdPose; against eager JAX ``apply``), through
``build_model(...).eval()`` and through ``build_pipeline(..., device="cpu")``,
against JAX's ``postprocess(model.apply)`` and
``detrpose_tpu/tools/infer.py::build_pipeline``'s ``run``; L and X are slow.
N with ``msda_backend="pallas"`` runs kernel #2's plain version through its
packed layout, against JAX's default gather path (the same function: JAX's
"pallas" path runs on the CPU only in interpret mode).

Weights are the seeded numpy draw of tests/test_torch_models.py, with the
two-stage selection head scaled by 50 (as tests/test_e2e_parity.py does) so the
top-60 anchor order is well defined on both sides. Tolerances: 1e-4 absolute
on logits and normalized keypoints, 1e-4 relative on scores and on keypoints
in original pixels; labels and the selected queries exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.models.postprocess import postprocess as jax_postprocess
from detrpose_tpu.tools.infer import build_pipeline as jax_build_pipeline

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models import postprocess
from detrpose_tpu_torch.tools.infer import build_pipeline, preprocess
from detrpose_tpu_torch.utils.convert import from_jax_variables

from test_torch_models import random_variables

torch.set_num_threads(2)
HW = 160


def _weights(size, seed, num_body_points=17):
    model = jax_build_model(jax_model_config(size, num_body_points=num_body_points))
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = random_variables(template, seed=seed)
    head = variables["params"]["transformer"]["enc_out_class_embed"]
    head["kernel"] = head["kernel"] * 50.0
    return model, variables


def _check_decoded(got, want):
    scores, labels, kpts = (t.numpy() for t in got)
    np.testing.assert_allclose(scores, np.asarray(want[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(labels, np.asarray(want[1]))
    np.testing.assert_allclose(kpts, np.asarray(want[2]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("size", ["n", "s", "m", pytest.param("l", marks=pytest.mark.slow),
                                  pytest.param("x", marks=pytest.mark.slow)])
def test_model_parity(size):
    _check_model_parity(size)


def test_pallas_backend_parity():
    _check_model_parity("n", msda_backend="pallas")


def test_crowdpose_model_parity():
    # N with 14 keypoints (CrowdPose) against eager JAX apply: at this seed
    # jitted JAX ranks two of the same top-60 anchors in the other order (the
    # encoder scores agree to ~1e-4), eager JAX and the port do not
    _check_model_parity("n", num_body_points=14, jit=False)


def _check_model_parity(size, num_body_points=17, jit=True, **overrides):
    jm, variables = _weights(size, seed=10, num_body_points=num_body_points)
    x = np.random.default_rng(11).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    sizes = np.array([[640, 480], [333, 500]], np.float32)
    apply = lambda v, im: jm.apply(v, im, train=False)  # noqa: E731
    out_j = (jax.jit(apply) if jit else apply)(variables, jnp.asarray(x))

    port = build_model(model_config(size, num_body_points=num_body_points, **overrides),
                       device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        out_t = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ("pred_logits", "pred_keypoints"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=0, atol=1e-4)
    _check_decoded(postprocess(out_t, torch.from_numpy(sizes), num_body_points=num_body_points),
                   jax_postprocess(out_j, jnp.asarray(sizes), num_body_points=num_body_points))


@pytest.mark.parametrize("size", ["n", "s"])
def test_pipeline_parity(size):
    _, variables = _weights(size, seed=12)
    rng = np.random.default_rng(13)
    run_j, _ = jax_build_pipeline(size, 17, None, res=HW, bf16=False)
    run_t = build_pipeline(size, res=HW, dtype=torch.float32, device="cpu")
    run_t.model.load_state_dict(from_jax_variables(variables), strict=True)
    for h, w in ((200, 180), (120, 150)):   # a shrink and a stretch
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = run_j(variables, jnp.asarray(img), jnp.asarray([w, h], jnp.float32))
        _check_decoded(run_t(img, (w, h)), want)


@pytest.mark.parametrize("hw", [(200, 180), (640, 480), (120, 150), (160, 160)])
def test_preprocess_matches_jax_resize(hw):
    # antialiased bilinear when shrinking, plain bilinear when growing; the two
    # frameworks sum the filter taps in another order (1e-5 on [0, 1] values)
    img = np.random.default_rng(14).integers(0, 256, hw + (3,)).astype(np.uint8)
    want = jax.image.resize(jnp.asarray(img, jnp.float32) / 255.0, (HW, HW, 3), "bilinear")
    got = preprocess(torch.from_numpy(img)[None], HW)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_pipeline_batch_equals_single():
    run = build_pipeline("n", res=HW, dtype=torch.float32, device="cpu")
    run.model.load_state_dict(from_jax_variables(_weights("n", seed=16)[1]), strict=True)
    imgs = np.random.default_rng(15).integers(0, 256, (3, HW, HW, 3)).astype(np.uint8)
    wh = np.array([[HW, HW]] * 3, np.float32)
    batch = run(imgs, wh)
    for i in range(3):
        single = run(imgs[i], wh[i])
        for a, b in zip(batch, single):
            torch.testing.assert_close(a[i:i + 1], b, rtol=1e-5, atol=1e-4)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pipeline("n")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(model_config("n"))


def test_unknown_msda_backend_raises():
    with pytest.raises(ValueError, match="msda_backend"):
        build_model(model_config("n", msda_backend="xla"), device="cpu")


@pytest.mark.parametrize("flag", ["use_modulation", "use_region_sampling",
                                  "use_global_context", "use_grouped_offsets",
                                  "use_grid_attention", "use_kan",
                                  "use_energy_refinement", "resnet"])
def test_experimental_flags_raise(flag):
    # build_model raised NotImplementedError for each of these until the
    # variants were ported (tests/test_torch_variants*.py hold them against
    # JAX); now each builds and runs. ResNet runs at S: N's two levels do not
    # take its three maps, in JAX either.
    cfg = (model_config("s", backbone_name="resnet50") if flag == "resnet"
           else model_config("n", **{flag: True}))
    with torch.no_grad():
        out = build_model(cfg, device="cpu")(torch.rand(1, 3, 128, 128))
    assert out["pred_keypoints"].shape == (1, 60, 34)
    assert torch.isfinite(out["pred_keypoints"]).all() and torch.isfinite(out["pred_logits"]).all()
