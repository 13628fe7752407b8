"""AdamW's state carried from the JAX package's optax state
(``detrpose_tpu_torch/utils/convert.py::optimizer_from_optax``, through
``convert_orbax`` and ``utils/checkpoint.py::restore_checkpoint``).

JAX ``model.init`` of N at 128 px, then JAX ``make_optimizer``'s transform
(milestone 1, gamma 0.5) advanced by seeded numpy gradients, with no forward:
two optimiser steps, and with accumulation 2 one micro-batch more, so the
state is in the middle of an accumulation. The cases: accumulation 1 and 2
with the clip, 1 without it (no ``chain``), and 2 with stages 0-1 of the
backbone frozen. JAX ``save_checkpoint`` writes the TrainState, and
``restore_checkpoint`` reads the directory into a port ``TrainStep`` of the
same optimiser settings with no warning: every parameter's ``exp_avg``,
``exp_avg_sq`` and ``step`` equal optax's ``mu``, ``nu`` and its label's
``count`` bit for bit, the groups keep the port's hyperparameters, frozen
parameters have no state, the accumulated
gradients equal ``acc_grads * mini_step`` and ``micro`` ``mini_step``. Then
one more micro-batch of the same gradient on both sides, which completes an
optimiser step: every parameter within 1e-6 of its leaf's max|x| (float32)
of JAX's.
"""
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.parallel.train_step import TrainState
from detrpose_tpu.train.optim import EMA as JaxEMA
from detrpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from detrpose_tpu.utils.checkpoint import save_checkpoint

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.parallel.train_step import make_train_step
from detrpose_tpu_torch.train.optim import label_parameters, make_optimizer
from detrpose_tpu_torch.utils.checkpoint import restore_checkpoint
from detrpose_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(2)
HW = 128
K = 17
OPTS = dict(milestones=(1,), gamma=0.5)
CASES = {
    "accum1": dict(grad_accum_steps=1),
    "accum2_mid_step": dict(grad_accum_steps=2),
    "accum1_no_clip": dict(grad_accum_steps=1, clip_max_norm=0.0),
    "accum2_frozen_stages": dict(grad_accum_steps=2, freeze_at=1, freeze_stem_only=False),
}


@pytest.fixture(scope="module")
def variables():
    jm = jax_build_model(jax_model_config("n"))
    return jax.tree.map(np.asarray, jax.jit(
        lambda r: jm.init(r, jnp.zeros((1, HW, HW, 3)), train=False))(jax.random.PRNGKey(0)))


def present(tree):
    """A params-shaped optax tree without its masked nodes."""
    if isinstance(tree, dict):
        kept = {k: present(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None}
    return None if isinstance(tree, optax.MaskedNode) else np.asarray(tree)


def partition(opt_state, k):
    """The multi_transform state inside JAX make_optimizer's transform."""
    inner = opt_state.inner_opt_state if k > 1 else opt_state
    return inner if hasattr(inner, "inner_states") else inner[-1]


def port_tree(tree):
    return from_jax_variables({"params": present(tree)})


def gradient(rng, params):
    return jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_carries_optax_state(variables, case, tmp_path):
    opts = dict(OPTS, **CASES[case])
    k = opts["grad_accum_steps"]
    params = variables["params"]
    tx = jax_make_optimizer(params, **opts)

    def update(g, st, p):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    update = jax.jit(update)
    rng = np.random.default_rng(40)
    opt_state = tx.init(params)
    micro = 2 * k + (1 if k > 1 else 0)      # two optimiser steps (and one micro-batch)
    for _ in range(micro):
        params, opt_state = update(gradient(rng, variables["params"]), opt_state, params)
    params = jax.tree.map(np.asarray, params)
    state = TrainState(step=jnp.asarray(micro, jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], opt_state=opt_state,
                       ema=JaxEMA.init(params, variables["batch_stats"]))
    save_checkpoint(str(tmp_path / "ckpt"), state, 3)

    port = build_model(model_config("n"), device="cpu").train()
    opt = make_optimizer(port, **opts)
    step = make_train_step(port, opt, K, device="cpu", compute_dtype=torch.float32)
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in opt.adamw.param_groups]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert restore_checkpoint(str(tmp_path / "ckpt"), step) == 3
    assert not [w for w in caught if "optimizer" in str(w.message)]
    # the groups keep this run's hyperparameters: optax's state carries none
    assert all(g[k] == v for g, h in zip(opt.adamw.param_groups, hyper) for k, v in h.items())

    # the carried state, bit for bit
    part = partition(opt_state, k)
    labels = label_parameters(port, freeze_at=opts.get("freeze_at", -1),
                              freeze_stem_only=opts.get("freeze_stem_only", True))
    named = dict(port.named_parameters())
    seen = set()
    for label in ("main", "backbone"):
        adam = part.inner_states[label].inner_state[0]
        sched = part.inner_states[label].inner_state[2]
        assert int(adam.count) == int(sched.count) == opt.updates == 2
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for name, want in port_tree(getattr(adam, field)).items():
                assert labels[name] == label, name
                st = opt.adamw.state[named[name]]
                assert torch.equal(st[key], want), (name, key)
                assert st["step"].item() == int(adam.count)
                seen.add(name)
    assert seen == {n for n, lab in labels.items() if lab != "frozen"}
    assert len(opt.adamw.state) == len(seen)
    if k > 1:
        assert step.micro == int(opt_state.mini_step) == 1
        for name, want in port_tree(opt_state.acc_grads).items():
            assert torch.equal(named[name].grad, want), name
    else:
        assert step.micro == 0 and all(p.grad is None for p in named.values())

    # one more micro-batch of the same gradient on both sides: an optimiser step
    g = gradient(rng, variables["params"])
    params, _ = update(g, opt_state, params)
    for name, t in port_tree(g).items():
        named[name].grad = t.clone() if named[name].grad is None else named[name].grad + t
    step.micro += 1
    assert step.micro == k
    opt.step()
    want = port_tree(jax.tree.map(np.asarray, params))
    moved = 0
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=name)
        moved += labels[name] != "frozen"
    assert moved == len(seen)
