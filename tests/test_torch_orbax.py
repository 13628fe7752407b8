"""The JAX package's orbax checkpoints read by the port
(``detrpose_tpu_torch/utils/convert.py::convert_orbax`` and its command line,
``tools/convert_orbax.py``), after tests/test_checkpoint.py.

JAX ``init_train_state`` for N at 160 px, its weights, BatchNorm statistics
and EMA stream replaced by seeded draws (so the EMA differs from the live
weights) and its AdamW state advanced by as many updates of seeded
gradients as the EMA's, written by JAX ``save_checkpoint`` into
``tmp_path``. The port reads
the directory through ``tools/infer.py::build_pipeline`` (converted in
memory) and its eval forward must match JAX ``restore_variables`` + ``apply``
within 1e-4 on logits and normalized keypoints, with the EMA preferred (as
JAX prefers it), with ``prefer_ema=False``, and from an EMA that carries no
statistics (both take the live ones). ``tools/export.py::build_serve``
reads the same weights. ``Trainer.resume`` on the converted file keeps the
weights, the EMA and the counters and carries AdamW's state without a
warning; the epoch follows the saved one. A Trainer with another freeze
mask (its groups differ from the JAX run's) warns that the optimiser starts
fresh. Without orbax the converter raises an ``ImportError`` that says how
to convert elsewhere. tests/test_torch_orbax_optimizer.py holds the carried
AdamW state to optax's bit for bit, and the next update to JAX's.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.parallel import init_train_state
from detrpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from detrpose_tpu.utils.checkpoint import restore_variables, save_checkpoint

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.tools.convert_orbax import main as convert_main
from detrpose_tpu_torch.tools.export import build_serve
from detrpose_tpu_torch.tools.infer import build_pipeline
from detrpose_tpu_torch.train.trainer import Trainer
from detrpose_tpu_torch.utils.convert import convert_orbax, drop_derived, load_torch_checkpoint

from test_torch_models import random_variables

torch.set_num_threads(2)
HW = 160
EPOCH, STEP, EMA_UPDATES = 7, 11, 5


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(the JAX model, the eval template, {name: orbax directory})."""
    jm = jax_build_model(jax_model_config("n"))
    x0 = jnp.zeros((1, HW, HW, 3))
    params_shape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0,
                                                  train=True))["params"]
    tx = jax_make_optimizer(params_shape)
    state = init_train_state(jm, tx, jax.random.PRNGKey(0), x0)
    rng = np.random.default_rng(30)
    opt_state, update = state.opt_state, jax.jit(tx.update)
    for _ in range(EMA_UPDATES):
        g = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), state.params)
        opt_state = update(g, opt_state, state.params)[1]
    live = random_variables({"params": state.params, "batch_stats": state.batch_stats},
                            seed=31)
    ema = random_variables({"params": state.params, "batch_stats": state.batch_stats},
                           seed=32)
    for v in (live, ema):   # a well-defined top-60 anchor order on both sides
        head = v["params"]["transformer"]["enc_out_class_embed"]
        head["kernel"] = head["kernel"] * 50.0
    state = state.replace(step=jnp.asarray(STEP, jnp.int32), params=live["params"],
                          opt_state=opt_state,
                          batch_stats=live["batch_stats"],
                          ema={**ema, "updates": jnp.asarray(EMA_UPDATES, jnp.int32)})
    root = tmp_path_factory.mktemp("orbax")
    paths = {"ema": str(root / "ckpt"), "ema_no_stats": str(root / "ckpt_no_stats")}
    save_checkpoint(paths["ema"], state, epoch=EPOCH)
    save_checkpoint(paths["ema_no_stats"],
                    state.replace(ema={"params": ema["params"], "batch_stats": {},
                                       "updates": jnp.asarray(EMA_UPDATES, jnp.int32)}),
                    epoch=EPOCH)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0, train=False))
    return jm, template, paths


@pytest.mark.parametrize("case,prefer_ema", [("ema", True), ("ema", False),
                                             ("ema_no_stats", True)])
def test_eval_output_matches_jax(saved, case, prefer_ema):
    jm, template, paths = saved
    x = np.random.default_rng(33).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    variables = restore_variables(paths[case], template, prefer_ema=prefer_ema)
    want = jax.jit(lambda v, im: jm.apply(v, im, train=False))(variables, jnp.asarray(x))
    if prefer_ema:
        run = build_pipeline("n", ckpt=paths[case], res=HW, dtype=torch.float32,
                             device="cpu")
        model = run.model
    else:
        model = build_model(model_config("n"), device="cpu")
        model.load_state_dict(drop_derived(load_torch_checkpoint(paths[case],
                                                                 prefer_ema=False)),
                              strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ("pred_logits", "pred_keypoints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_export_reads_the_directory(saved):
    _, _, paths = saved
    serve = build_serve("n", ckpt=paths["ema"], bf16=False, fuse=False, device="cpu")
    want = drop_derived(convert_orbax(paths["ema"])["ema"]["module"])
    got = serve.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _trainer(tmp_path, name, **kwargs):
    return Trainer(build_model(model_config("n"), device="cpu"), model_config("n"),
                   output_dir=str(tmp_path / name), device="cpu", tensorboard=False,
                   compute_dtype=torch.float32, log_fn=lambda *a: None, **kwargs)


def test_resume_from_the_converted_file(saved, tmp_path, recwarn):
    _, _, paths = saved
    pth = str(tmp_path / "converted.pth")
    convert_main([paths["ema"], pth])
    ckpt = torch.load(pth, weights_only=False)
    assert ckpt["epoch"] == EPOCH and ckpt["optimizer"]["state"]
    tr = _trainer(tmp_path, "out")
    tr.resume(pth)
    assert tr.start_epoch == EPOCH + 1
    assert (tr.step.step, tr.step.micro, tr.optimizer.updates, tr.step.ema.updates) == (
        STEP, 0, EMA_UPDATES, EMA_UPDATES)
    assert {st["step"].item() for st in tr.optimizer.adamw.state.values()} == {EMA_UPDATES}
    for k, v in tr.step.model.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    for k, v in tr.step.ema.state_dict().items():
        assert torch.equal(v, ckpt["ema"]["module"][k]), k
    # the directory itself resumes the same way (converted in memory)
    other = _trainer(tmp_path, "out2")
    other.resume(paths["ema"])
    assert other.start_epoch == EPOCH + 1
    assert len(other.optimizer.adamw.state) == len(tr.optimizer.adamw.state)
    assert not [w for w in recwarn if "optimizer" in str(w.message)]
    # another freeze mask: the JAX run's groups do not fit, AdamW starts fresh
    frozen = _trainer(tmp_path, "out3", freeze_at=1, freeze_stem_only=False)
    with pytest.warns(UserWarning, match="does not match the current optimizer"):
        frozen.resume(pth)
    assert frozen.start_epoch == EPOCH + 1 and not frozen.optimizer.adamw.state
    assert (frozen.step.micro, frozen.optimizer.updates) == (0, EMA_UPDATES)


def test_without_orbax_the_converter_says_how(saved, monkeypatch):
    _, _, paths = saved
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="convert_orbax"):
        load_torch_checkpoint(paths["ema"])
