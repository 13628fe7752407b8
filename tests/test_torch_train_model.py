"""The port's training forward and its CDN queries against the JAX package.

``DETRPose.train()(x, dn=...)`` against JAX ``model.apply(..., train=True,
dn=dn, mutable=["batch_stats"])`` on one CDN batch, at N and S, 160 px,
batch 2, float32, for 17 (COCO) and 14 (CrowdPose) keypoints. Weights are the
seeded numpy draw of tests/test_torch_models.py with the selection head
scaled by 50; each case first checks that the port's top-61 encoder scores
are at least 1e-2 apart, so the top-60 order is defined on both sides (two
scores within the frameworks' ~1e-5 relative drift would swap two query
slots).

Tolerances: 1e-4 absolute on the normalized keypoints and FDR corners of
every branch. Logits: 2e-4 absolute up to 1 in size, 2e-4 of their largest
beyond (the class heads' ~2): in training the encoder's batch-statistics
norms carry the conv stacks' ~5e-5 relative drift into them, measured at
1.0-1.3e-4 on logits ~2 in size. The query selection's logits (the x50 head,
~150 in size) to 1e-4 of their largest. The BatchNorm statistics the forward moves: the
encoder's first norms (``input_proj``, right after the backbone) to 1e-6 of
each tensor's largest value, which pins the biased-variance update; every
encoder norm to 1e-4 (deeper norms see the conv stacks' ~1e-5 drift); the
backbone's unchanged, bit for bit. A single BatchNorm against Flax's to
1e-6. ``build_cdn`` bit for bit against JAX's from the same numpy seed.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.models.layers import BatchNorm as JBatchNorm
from detrpose_tpu.train.cdn import CDNConfig as JCDNConfig
from detrpose_tpu.train.cdn import build_cdn as jax_build_cdn

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models.layers import BatchNorm
from detrpose_tpu_torch.models.transformer import make_anchors
from detrpose_tpu_torch.train.cdn import CDNConfig, build_cdn, cdn_to_device
from detrpose_tpu_torch.utils.convert import from_jax_variables

from test_torch_models import random_variables

torch.set_num_threads(2)
HW, B = 160, 2


def synthetic_targets(rng, B, G, K, n_valid=None):
    """Padded targets as ``bench_train_step`` makes them, with ``n_valid``
    (per image) valid GTs first."""
    kxy = rng.uniform(0.2, 0.8, (B, G, K, 2)).astype(np.float32)
    vis = (rng.uniform(size=(B, G, K)) > 0.2).astype(np.float32)
    valid = np.ones((B, G), bool)
    if n_valid is not None:
        valid = np.arange(G)[None, :] < np.asarray(n_valid)[:, None]
    return {"labels": np.zeros((B, G), np.int32),
            "boxes": np.concatenate([kxy.mean(2), rng.uniform(0.1, 0.4, (B, G, 2))
                                     .astype(np.float32)], -1),
            "keypoints": np.concatenate([kxy.reshape(B, G, 2 * K), vis], -1),
            "area": rng.uniform(0.02, 0.2, (B, G)).astype(np.float32),
            "valid": valid}


def jax_dn(dn):
    """``build_cdn``'s output as the JAX model takes it under jit."""
    return {k: jax.tree.map(jnp.asarray, v) for k, v in dn.items()
            if k not in ("pad_size", "num_dn_group")}


def train_weights(size, K, seed):
    jm = jax_build_model(jax_model_config(size, num_body_points=K))
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
    variables = random_variables(template, seed=seed)
    head = variables["params"]["transformer"]["enc_out_class_embed"]
    head["kernel"] = head["kernel"] * 50.0
    return jm, variables


def port_model(size, K, variables):
    port = build_model(model_config(size, num_body_points=K), device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port.train()


def topk_margin(port, x, nq=60):
    """Least gap between neighbouring encoder scores among the port's top
    nq+1, on a copy (the forward moves the norms' statistics)."""
    m = copy.deepcopy(port)
    with torch.no_grad():
        feats = m.encoder(m.backbone(x))
        tr = m.transformer
        mem = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)
        _, invalid = make_anchors([(int(f.shape[2]), int(f.shape[3])) for f in feats])
        scores = tr.enc_out_class_embed(tr.enc_output_norm(
            tr.enc_output(mem.masked_fill(invalid, 0.0)))).amax(-1)
        top = scores.sort(dim=1, descending=True).values[:, :nq + 1]
    return (top[:, :-1] - top[:, 1:]).min().item()


def _close(got, want, atol, name):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= atol, (name, err, atol)


def compare_train_outputs(got, want):
    """Every entry of the JAX train dict against the port's."""
    for k in ("up", "reg_scale", "reg_max"):
        assert got[k] == want[k], k
    branches = ([("", got, want)]
                + [(f"aux_{i}", g, w) for i, (g, w) in
                   enumerate(zip(got["aux_outputs"], want["aux_outputs"], strict=True))]
                + [("dn_" + str(i), g, w) for i, (g, w) in
                   enumerate(zip(got["dn_aux_outputs"], want["dn_aux_outputs"], strict=True))]
                + [("pre", got["aux_pre_outputs"], want["aux_pre_outputs"]),
                   ("dn_pre", got["dn_aux_pre_outputs"], want["dn_aux_pre_outputs"])])
    n = 0
    for label, g, w in branches:
        keys = {k for k in w if k != "is_dn"}
        if label == "":
            keys -= {"aux_outputs", "aux_interm_outputs", "aux_pre_outputs",
                     "dn_aux_outputs", "dn_aux_pre_outputs", "dn_meta", "up",
                     "reg_scale", "reg_max", "energy_reg_loss"}
        for k in sorted(keys):
            tol = (2e-4 * max(1.0, float(np.abs(np.asarray(w[k])).max()))
                   if "logits" in k else 1e-4)
            _close(g[k], w[k], tol, f"{label}.{k}")
            n += 1
        assert g.get("is_dn") == w.get("is_dn"), label
    (gi,), (wi,) = got["aux_interm_outputs"], want["aux_interm_outputs"]
    _close(gi["pred_keypoints"], wi["pred_keypoints"], 1e-4, "interm.pred_keypoints")
    scale = float(np.abs(np.asarray(wi["pred_logits"])).max())
    _close(gi["pred_logits"], wi["pred_logits"], 1e-4 * scale, "interm.pred_logits")
    assert got["dn_meta"]["pad_size"] == want["dn_meta"]["pad_size"]
    assert float(got["dn_meta"]["num_dn_group"]) == float(want["dn_meta"]["num_dn_group"])
    return n


@pytest.mark.parametrize("size,K,seed", [("n", 17, 20), ("s", 17, 38), ("n", 14, 32),
                                         ("s", 14, 23)])
def test_train_forward_matches_jax(size, K, seed):
    jm, variables = train_weights(size, K, seed)
    rng = np.random.default_rng(seed)
    targets = synthetic_targets(rng, B, 3, K, n_valid=[3, 2])
    dn = build_cdn(targets, 60, K, (HW, HW), np.random.default_rng(seed + 100))
    x = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    port = port_model(size, K, variables)
    margin = topk_margin(port, xt)
    assert margin > 1e-2, f"top-61 scores only {margin:.2e} apart: the top-60 order is a tie"
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(xt, cdn_to_device(dn, "cpu"))

    want, mut = jax.jit(lambda v, im, d: jm.apply(v, im, train=True, dn=d,
                                                  mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jax_dn(dn))
    L = len(want["dn_aux_outputs"])
    assert compare_train_outputs(got, want) == 4 + 6 * (L - 1) + 6 * L + 4

    stats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    sd = port.state_dict()
    n_enc = 0
    for k, w in stats.items():
        w, g = w.numpy(), sd[k].numpy()
        if k.startswith("backbone."):
            np.testing.assert_array_equal(g, before[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(w, before[k].numpy(), err_msg=k)
            continue
        n_enc += 1
        assert not np.array_equal(g, before[k].numpy()), f"{k} did not move"
        rel = 1e-6 if ".input_proj." in f".{k}" else 1e-4
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (k, np.abs(g - w).max())
    assert n_enc > 20


def test_batchnorm_train_matches_flax():
    # one norm, 18 values a channel (the running variance's biased and
    # unbiased forms differ by 18/17): output and both statistics to 1e-6
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 3, 8)) * 2 + 0.5).astype(np.float32)   # NHWC
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    want, mut = JBatchNorm().apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    bn = BatchNorm(8).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-6 * np.abs(np.asarray(want)).max())
    for t, k in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        w = np.asarray(mut["batch_stats"]["bn"][k])
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, 8).var(0, ddof=1)
    assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-3   # not torch's form
    bn.eval()
    assert torch.equal(bn(torch.ones(1, 8, 2, 2)), bn(torch.ones(1, 8, 2, 2)))


def test_train_mode_freezes_backbone_norms():
    port = build_model(model_config("n"), device="cpu").train()
    norms = [(n, m) for n, m in port.named_modules() if isinstance(m, BatchNorm)]
    assert all(not m.training for n, m in norms if n.startswith("backbone."))
    assert all(m.training for n, m in norms if n.startswith("encoder."))
    assert sum(n.startswith("encoder.") for n, _ in norms) > 20
    port.eval()
    assert not any(m.training for _, m in norms)


def test_train_forward_without_dn():
    # no GT in the batch: no denoising block, no DN outputs
    port = build_model(model_config("n"), device="cpu").train()
    out = port(torch.rand(1, 3, HW, HW), None)
    assert "dn_aux_outputs" not in out and "dn_meta" not in out
    assert out["pred_keypoints"].shape == (1, 60, 34)
    assert len(out["aux_outputs"]) == 2 and out["aux_pre_outputs"]["pred_logits"].shape == (1, 60, 2)


def test_pallas_backend_refuses_training():
    # kernel #2's op has no gradient (nor has the JAX kernel): a training
    # forward must say so, not train without the MSDA gradient
    port = build_model(model_config("n", msda_backend="pallas"), device="cpu").train()
    with pytest.raises(RuntimeError, match="'auto' or 'gather'"):
        port(torch.rand(1, 3, HW, HW))
    with torch.no_grad():
        port(torch.rand(1, 3, HW, HW))          # no gradient wanted: it runs


@pytest.mark.parametrize("case", ["coco", "crowdpose", "over_capacity", "one_gt", "no_gt"])
def test_build_cdn_matches_jax(case):
    K = 14 if case == "crowdpose" else 17
    G = {"over_capacity": 40, "one_gt": 1}.get(case, 5)
    rng = np.random.default_rng(7)
    n_valid = {"over_capacity": [40, 33], "no_gt": [0, 0], "one_gt": [1, 0]}.get(case, [5, 3])
    targets = synthetic_targets(rng, B, G, K, n_valid=n_valid)
    want = jax_build_cdn(targets, 60, K, (HW, 2 * HW), np.random.default_rng(8))
    got = build_cdn(targets, 60, K, (HW, 2 * HW), np.random.default_rng(8))
    if case == "no_gt":
        assert want is None and got is None
        return
    assert got.keys() == want.keys() and got["dn_match"].keys() == want["dn_match"].keys()
    for k in want:
        if k == "dn_match":
            for kk in want[k]:
                np.testing.assert_array_equal(got[k][kk], want[k][kk], err_msg=kk)
                assert np.asarray(got[k][kk]).dtype == np.asarray(want[k][kk]).dtype, kk
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert got["pad_size"] == CDNConfig().pad_cap == JCDNConfig().pad_cap == 64
    if case == "over_capacity":       # at most pad_cap // 2 GTs get noised copies
        assert got["slot_used"].sum(1).max() <= 64


def test_cdn_to_device():
    targets = synthetic_targets(np.random.default_rng(9), B, 4, 17)
    dn = build_cdn(targets, 60, 17, (HW, HW), np.random.default_rng(10))
    t = cdn_to_device(dn, "cpu")
    assert t["labels"].dtype == torch.int64 and t["attn_mask"].dtype == torch.bool
    assert t["pose_logits"].dtype == torch.float32 and t["slot_used"].dtype == torch.bool
    assert t["dn_match"]["query_idx"].dtype == torch.int64
    assert t["dn_match"]["num_group"].dtype == torch.float32
    assert t["pad_size"] == 64 and isinstance(t["num_dn_group"], int)
    np.testing.assert_array_equal(t["pose_logits"].numpy(), dn["pose_logits"])
    assert cdn_to_device(None, "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cdn_to_device(dn)
