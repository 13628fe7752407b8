"""The energy refinement's training gradients in the port against JAX's.

One N training forward and backward with energy refinement (``grad_energy``,
one step, ``energy_decrease_weight`` 0.01) at 160 px, batch 2, float32, on
the loss of JAX tests/test_energy.py::test_energy_refinement_train_grads: the
sum of the squared keypoints plus ``energy_reg_loss``. The descent's step is
differentiated, so kernel #1's op (the "auto" backend, its CPU path) is
differentiated twice. The loss to 1e-4 relative; every parameter's gradient
against ``jax.grad`` to 1e-3 of its leaf's largest |g| (1e-5 of the largest
|g| of any leaf where a leaf's is 0 up to rounding), ``energy_layer`` and
``energy_step_size`` among them. A leaf whose float32 gradient is
ill-conditioned, shown by JAX's own being off a float64 run of the port by
more than 5e-4 of its max|g|, is held to JAX at 5e-2 in relative L2 norm;
at most 1 leaf in 20 may be.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu_torch.utils.convert import from_jax_variables

from test_torch_variants_model import HW, _port, _weights

torch.set_num_threads(2)


def test_energy_train_gradients_match_jax():
    flags = dict(use_energy_refinement=True, energy_steps=1, grad_energy=True,
                 energy_decrease_weight=0.01)
    jm, variables = _weights("n", flags, seed=14)
    x = np.random.default_rng(15).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out["pred_keypoints"] ** 2) + out["energy_reg_loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"])
    want = {k: v.numpy() for k, v in from_jax_variables({"params": grads_j}).items()}
    grads = {}
    for dtype in (torch.float32, torch.float64):
        port = _port("n", flags, variables).to(dtype).train()
        out = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype))
        loss = (out["pred_keypoints"] ** 2).sum() + out["energy_reg_loss"]
        loss.backward()
        grads[dtype] = {n: p.grad.double().numpy() for n, p in port.named_parameters()
                        if p.grad is not None}
        if dtype == torch.float32:
            np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    got, witness = grads[torch.float32], grads[torch.float64]
    assert got.keys() == witness.keys()
    assert any(n.startswith("transformer.decoder.energy_layer.") for n in got)
    assert "transformer.decoder.energy_step_size" in got
    top = max(np.abs(w).max() for w in want.values())
    drift = []
    for name, w in want.items():
        if name not in got:
            # a leaf the loss does not reach (the DN embeddings, the class
            # heads of the earlier layers) has no gradient on either side
            assert np.abs(w).max() == 0.0, name
            continue
        g, h = got[name], witness[name]
        scale = max(np.abs(w).max(), 1e-5 * top)
        if np.abs(g - w).max() <= 1e-3 * scale:
            continue
        # an ill-conditioned float32 gradient (the backbone's affine
        # scalars, sums over every pixel that cancel): JAX's own is off the
        # port's float64 run by more than 5e-4 of its max|g|, so it cannot
        # decide 1e-3; held to JAX at 5e-2 in relative L2 norm
        drift.append(name)
        assert np.abs(w - h).max() > 5e-4 * scale, (name, np.abs(g - w).max() / scale)
        assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w) + 1e-6 * top, name
    assert len(drift) <= len(got) // 20, drift
