"""The port's training step, optimiser and EMA against the JAX package.

One step at N, 160 px, batch 2, float32, one CDN batch, from the same
weights: ``loss_total`` against JAX ``make_train_step``'s metrics (1e-4
relative), and every parameter's gradient against its ``jax.grad`` (kept by
an optimiser that stores them), leaf by leaf through ``utils/convert.py``'s
names, to 1e-3 of the leaf's largest |g|, but for the leaves named below.
Their float32 gradients are ill-conditioned at this seed, as a float64 run of
the port (the witness, made in the test) shows. ``JAX_DRIFT``: JAX's float32
gradient is off the witness by more than 5e-4 of its max|g| (up to 2e-2, in
decoder layer 0, where the drift switches a ReLU unit of ``linear1``), the
port's float32 one by at most 3e-4; each is held to the witness at 1e-3 of
its max|g| and to JAX at 5e-2 in relative L2 norm. ``ILL_CONDITIONED``: both
float32 gradients are off the witness, mostly gradients that cancel to 0
up to rounding behind the encoder's batch-statistics norms (which remove
per-channel shifts: the biases of ``input_proj.0.norm``, of the AIFI layer's
``norm2``...) and LearnableAffineBlock scalars; each is held to JAX at 5e-2
in relative L2 norm or 1e-6 of the largest |g| of any leaf.
The optimiser fed the same gradients for 3 optimiser steps of 2
micro-batches each, against ``make_optimizer(grad_accum_steps=2)`` with a
milestone, the clip engaged and the frozen groups: parameters to 1e-6. The
EMA against ``EMA.update``, BatchNorm statistics included (1e-6). The skip on
a non-finite loss, with and without accumulation; ``remat``; the device rule.
"""
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.parallel.train_step import TrainState
from detrpose_tpu.parallel.train_step import make_train_step as jax_make_train_step
from detrpose_tpu.train.optim import EMA as JEMA
from detrpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from detrpose_tpu.train.optim import multistep_schedule as jax_multistep_schedule
from detrpose_tpu.train.optim import resolve_backbone_freeze as jax_resolve_backbone_freeze

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models.layers import BatchNorm
from detrpose_tpu_torch.parallel.train_step import make_train_step
from detrpose_tpu_torch.tools.benchmark import bench_train_step
from detrpose_tpu_torch.train.cdn import build_cdn, cdn_to_device
from detrpose_tpu_torch.train.optim import (EMA, AdamW, label_parameters, make_optimizer,
                                           multistep_schedule, resolve_backbone_freeze)
from detrpose_tpu_torch.utils.convert import from_jax_variables

from test_torch_train_model import (HW, jax_dn, port_model, synthetic_targets,
                                    train_weights)

torch.set_num_threads(2)
K = 17

# the leaves of the N model whose float32 gradient is ill-conditioned at
# seed 20 (see the module docstring)
ILL_CONDITIONED = (
    "encoder.input_proj.0.norm.bias",
    "encoder.downsample_convs.0.0.cv2.norm.bias",
    "encoder.encoder.0.layers.0.norm2.bias",
    "backbone.stages.3.blocks.0.aggregation.1.lab.bias",
    "backbone.stem.stem2b.lab.bias",
    "backbone.stages.2.blocks.1.layers.1.conv2.lab.scale",
)
JAX_DRIFT = (
    "transformer.decoder.layers.0.linear1.weight",
    "transformer.decoder.layers.0.linear1.bias",
    "transformer.decoder.layers.0.cross_attn.sampling_offsets.weight",
    "transformer.decoder.layers.0.cross_attn.sampling_offsets.bias",
    "transformer.decoder.layers.0.cross_attn.attention_weights.weight",
    "transformer.decoder.layers.0.cross_attn.attention_weights.bias",
    "transformer.decoder.layers.0.gateway.gate.weight",
    "transformer.decoder.layers.0.gateway.gate.bias",
    "transformer.decoder.layers.0.gateway.norm.weight",
    "transformer.decoder.layers.0.gateway.norm.bias",
    "transformer.decoder.layers.0.across_attn.in_proj_weight",
    "transformer.decoder.layers.0.across_attn.out_proj.weight",
    "transformer.decoder.layers.0.across_attn.out_proj.bias",
    "transformer.decoder.layers.0.across_norm.bias",
    "transformer.decoder.layers.0.within_norm.weight",
    "transformer.decoder.layers.0.within_norm.bias",
    "transformer.decoder.layers.2.cross_attn.sampling_offsets.weight",
    "transformer.decoder.layers.2.cross_attn.sampling_offsets.bias",
    "transformer.decoder.half_pose_ref_point_head.layers.0.weight",
    "transformer.decoder.half_pose_ref_point_head.layers.0.bias",
    "transformer.decoder.half_pose_ref_point_head.layers.1.weight",
    "transformer.decoder.half_pose_ref_point_head.layers.1.bias",
    "transformer.keypoint_embedding.weight",
    "transformer.tgt_embed.weight",
    "transformer.lqe_embed.0.reg_conf.layers.0.weight",
    "transformer.lqe_embed.0.reg_conf.layers.0.bias",
    "transformer.lqe_embed.2.reg_conf.layers.0.weight",
    "transformer.lqe_embed.2.reg_conf.layers.0.bias",
    "backbone.stem.stem3.lab.scale",
    "backbone.stem.stem4.lab.bias",
    "backbone.stages.2.blocks.0.aggregation.0.lab.bias",
    "backbone.stages.2.blocks.0.aggregation.1.lab.scale",
    "backbone.stages.2.blocks.0.layers.1.conv2.lab.bias",
    "backbone.stages.2.blocks.0.layers.2.conv2.lab.scale",
    "backbone.stages.3.blocks.0.aggregation.1.lab.scale",
)


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    targets = synthetic_targets(rng, B, 3, K, n_valid=[3, 2][:B])
    dn = build_cdn(targets, 60, K, (HW, HW), np.random.default_rng(seed + 100))
    x = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    return targets, dn, x


def _port_batch(targets, dn, x):
    return {"images": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            "targets": {k: torch.from_numpy(v) for k, v in targets.items()},
            "dn": cdn_to_device(dn, "cpu")}


def _port_step(model, accum=2, **kw):
    opt = make_optimizer(model, grad_accum_steps=accum)
    kw.setdefault("compute_dtype", torch.float32)
    return make_train_step(model, opt, K, device="cpu", **kw)


def test_one_step_matches_jax():
    jm, variables = train_weights("n", K, 20)
    targets, dn, x = _batch(20)
    jt = jax.tree.map(jnp.asarray, targets)
    jd = jax_dn(dn)
    # an optimiser that keeps the gradients in its state and moves nothing:
    # make_train_step's own gradients, from its own loss
    tx = optax.GradientTransformation(
        lambda p: {"grads": jax.tree.map(jnp.zeros_like, p)},
        lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), {"grads": g}))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, metrics = jax.jit(jax_make_train_step(jm, tx, K, use_ema=False))(
        state, {"images": jnp.asarray(x), "targets": jt, "dn": jd})
    assert bool(metrics["finite"])
    want = from_jax_variables(
        {"params": jax.tree.map(np.asarray, new_state.opt_state["grads"])})

    port = port_model("n", K, variables)
    step = _port_step(port, accum=2, use_ema=False)     # the first micro-batch keeps .grad
    m = step(_port_batch(targets, dn, x))
    assert m["finite"] and step.optimizer.updates == 0
    np.testing.assert_allclose(m["loss_total"].item(), float(metrics["loss_total"]), rtol=1e-4)
    witness = port_model("n", K, variables).double()
    batch64 = _port_batch(targets, dn, x)
    batch64["images"] = batch64["images"].double()
    assert _port_step(witness, accum=2, use_ema=False, compute_dtype=None)(batch64)["finite"]
    named, wit = dict(port.named_parameters()), dict(witness.named_parameters())
    assert want.keys() == named.keys()
    named_leaves = set(ILL_CONDITIONED + JAX_DRIFT)
    assert len(named_leaves) == 41 and named_leaves <= want.keys()
    top = max(w.abs().max().item() for w in want.values())
    bad = []
    for name, w in want.items():
        w = w.numpy()
        g = named[name].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        l2 = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        if name in ILL_CONDITIONED:
            ok = np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w) + 1e-6 * top
        elif name in JAX_DRIFT:
            h = wit[name].grad.numpy()
            ok = np.abs(g - h).max() <= 1e-3 * np.abs(h).max() and l2 <= 5e-2
        else:
            ok = np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
        if not ok:
            bad.append((name, np.abs(g - w).max() / np.abs(w).max(), l2))
    assert not bad, bad


@pytest.mark.parametrize("freeze", ["norms", "stages"])
def test_optimizer_matches_jax(freeze):
    _, variables = train_weights("n", K, 30)
    params = variables["params"]
    opts = dict(grad_accum_steps=2, milestones=(1,), gamma=0.5, clip_max_norm=0.1,
                warmup_steps=0)
    if freeze == "stages":
        opts.update(freeze_at=1, freeze_stem_only=False)
    tx = jax_make_optimizer(params, **opts)
    port = port_model("n", K, variables)
    opt = make_optimizer(port, **opts)

    labels = label_parameters(port, freeze_at=opts.get("freeze_at", -1),
                              freeze_stem_only=opts.get("freeze_stem_only", True))
    assert {"main", "backbone", "frozen"} == set(labels.values())
    start = from_jax_variables({"params": params})

    rng = np.random.default_rng(31)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, st, p)))
    named = dict(port.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    for micro in range(6):
        g = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
        params, opt_state = update(g, opt_state, params)
        for name, t in from_jax_variables({"params": g}).items():
            named[name].grad = t.clone() if named[name].grad is None else named[name].grad + t
        if micro % 2 == 1:
            norm = opt.step()
            assert norm.item() > 0.1                   # the clip engaged
            got = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
            for name, w in got.items():
                np.testing.assert_allclose(named[name].detach().numpy(), w.numpy(), rtol=0,
                                           atol=1e-6, err_msg=name)
    assert opt.updates == 3
    # the two sides freeze the same leaves
    end = from_jax_variables({"params": jax.tree.map(np.asarray, params)})
    for name, p in named.items():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (labels[name] != "frozen") == (not torch.equal(end[name], start[name])), name


@pytest.mark.parametrize("flag", ["amsgrad", "maximize", "foreach", "fused", "capturable",
                                  "differentiable"])
def test_adamw_refuses_the_flags_its_step_ignores(flag):
    with pytest.raises(TypeError, match=flag):
        AdamW([torch.nn.Parameter(torch.zeros(2))], lr=1e-4, **{flag: True})


@pytest.mark.parametrize("args", [("B4",), ("resnet50",), ("resnet50", 2), ("resnet50", -1, True, True)])
def test_resolve_backbone_freeze_matches_jax(args):
    assert resolve_backbone_freeze(*args) == jax_resolve_backbone_freeze(*args)


def test_multistep_schedule_matches_jax():
    for warmup in (0, 3):
        want = jax_multistep_schedule(1e-4, (2, 5), 0.1, warmup)
        got = multistep_schedule(1e-4, (2, 5), 0.1, warmup)
        for step in range(8):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=step)


def test_ema_matches_jax():
    port = build_model(model_config("n"), device="cpu")
    ema = EMA(port, decay=0.99, warmups=3)
    sd0 = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    bn_keys = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    state = JEMA.init({k: sd0[k] for k in sd0 if k not in bn_keys},
                      {k: sd0[k] for k in bn_keys})
    rng = np.random.default_rng(40)
    for _ in range(3):
        with torch.no_grad():
            for t in port.state_dict().values():
                t.add_(torch.from_numpy(rng.normal(0, 0.1, tuple(t.shape)).astype(np.float32)))
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        state = JEMA.update(state, {k: sd[k] for k in sd if k not in bn_keys}, 0.99, 3,
                            batch_stats={k: sd[k] for k in bn_keys})
        ema.update(port)
    assert ema.updates == int(state["updates"]) == 3
    got = ema.state_dict()
    assert got.keys() == sd0.keys()
    for k in sd0:
        want = state["batch_stats"][k] if k in bn_keys else state["params"][k]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=k)


def _snapshot(step):
    model, opt = step.model, step.optimizer
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: None if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "adamw": copy.deepcopy(opt.adamw.state_dict()),
            "ema": {k: v.clone() for k, v in step.ema.state_dict().items()},
            "counts": (opt.updates, step.ema.updates, step.micro)}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("accum", [1, 2])
def test_non_finite_loss_skips_the_update(accum):
    _, variables = train_weights("n", K, 50)
    targets, dn, x = _batch(50)
    step = _port_step(port_model("n", K, variables), accum=accum, ema_decay=0.9,
                      ema_warmups=2)
    batch = _port_batch(targets, dn, x)
    bad = dict(batch, images=batch["images"].clone())
    bad["images"][0, 0, 5, 5] = float("nan")
    assert step(batch)["finite"]                      # AdamW and EMA state exist
    if accum == 2:
        assert step(batch)["finite"] and step.optimizer.updates == 1
        assert step(batch)["finite"] and step.micro == 1   # one gradient held
    before, calls = _snapshot(step), step.step
    m = step(bad)
    assert not m["finite"] and not torch.isfinite(m["loss_total"])
    assert m["step"] == step.step == calls + 1
    assert _same(_snapshot(step), before)
    # the skipped micro-batch did not count towards the k
    updates = step.optimizer.updates
    assert step(batch)["finite"]
    assert step.optimizer.updates == updates + 1 and step.ema.updates == updates + 1
    assert step.step == (5 if accum == 2 else 3)


def test_remat_gives_the_same_gradients():
    # torch.utils.checkpoint around each backbone stage and decoder layer:
    # the recomputed forward, kernel #1's custom op (its plain version on the
    # CPU) included, gives the gradients of the stored one
    _, variables = train_weights("n", K, 60)
    targets, dn, x = _batch(60)
    grads = {}
    for remat in (False, True):
        port = build_model(model_config("n", remat=remat), device="cpu")
        port.load_state_dict(from_jax_variables(variables), strict=True)
        step = _port_step(port, accum=2, use_ema=False)
        assert step(_port_batch(targets, dn, x))["finite"]
        grads[remat] = {n: p.grad for n, p in port.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=1e-6, atol=1e-9, msg=n)


def test_bench_train_step_on_the_cpu():
    r = bench_train_step("n", batch=2, res=HW, device="cpu", warmup=1, iters=2,
                         grad_accum_steps=2)
    assert r["basis"] == "cpu_host_clock" and r["device"] == "cpu"
    assert r["step_ms"] > 0 and r["images_per_sec"] > 0 and r["finite"]
    assert r["launches"] == {k: 0 for k in r["launches"]}


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = build_model(model_config("n"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(port, make_optimizer(port), K)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_train_step("n", batch=1, res=HW)
    with pytest.raises(ValueError, match="lies on"):
        make_train_step(port, make_optimizer(port), K, device="meta")
    assert all(not m.training for m in port.modules() if isinstance(m, BatchNorm))
