"""The energy layer runs on "auto" whatever the model's MSDA backend, as JAX
builds it (``detrpose_tpu/models/decoder.py:788-791``).

N at 160 px, batch 2, float32, energy refinement by the energy's gradient in
one step, under ``torch.no_grad()`` as every eval entry point calls the
model: ``msda_backend="pallas"`` (kernel #2's plain version in the main
layers; the energy layer on "auto", whose op has a gradient) against the
port's "gather" and against JAX's "gather", 1e-4 absolute on logits and
normalized keypoints. Training under "pallas" still raises in the main layers
(tests/test_torch_train_model.py::test_pallas_backend_refuses_training).
"""
import numpy as np
import torch

import jax.numpy as jnp

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models import MSDeformAttn

from test_torch_variants_model import HW, _port, _weights

torch.set_num_threads(2)

FLAGS = dict(use_energy_refinement=True, energy_steps=1, grad_energy=True)


def test_energy_layer_is_built_on_auto():
    model = build_model(model_config("n", msda_backend="pallas", **FLAGS), device="cpu")
    decoder = model.transformer.decoder
    backends = {m.msda_backend for m in decoder.layers.modules() if isinstance(m, MSDeformAttn)}
    assert backends == {"pallas"}
    assert decoder.energy_layer.cross_attn.msda_backend == "auto"


def test_pallas_with_grad_energy_matches_gather():
    jm, variables = _weights("n", dict(FLAGS, msda_backend="gather"), seed=12)
    # a step that moves the keypoints: the gradient is a mean over 2 x 60 x 18 tokens
    variables["params"]["transformer"]["decoder"]["energy_step_size"] = np.full(
        (1,), 1e3, np.float32)
    x = np.random.default_rng(11).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    outs = {}
    for backend in ("pallas", "gather"):
        port = _port("n", dict(FLAGS, msda_backend=backend), variables)
        with torch.no_grad():
            outs[backend] = port(xt)
    for k in ("pred_logits", "pred_keypoints"):
        np.testing.assert_allclose(outs["pallas"][k].numpy(), outs["gather"][k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=f"{k}: pallas vs gather")
        np.testing.assert_allclose(outs["pallas"][k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-4, err_msg=f"{k}: pallas vs JAX gather")
