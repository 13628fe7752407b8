"""The port's matcher and criterion against the JAX package, on the CPU.

``oks``, ``match_cost`` and ``union_indices`` against JAX's (1e-6);
``auction_assign`` equal to JAX's on seeded random costs with invalid
columns, and to ``scipy_assign`` (the reference's exact LSAP); the criterion
term by term, by name, on JAX's own train outputs of N at 160 px (one CDN
batch) carried into torch: the default losses ("vfl", "keypoints") and with
"labels", "mal" and "local" too, DN branches included (1e-5 relative). Its
gradient with respect to every logits, keypoints and corners leaf of those
outputs against ``jax.grad`` (1e-5 of each leaf's largest |g|, and 1e-9
where that is below 1e-4: such a gradient is 0 up to rounding). Both sides
match with the auction, each branch as its own problem.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.ops.oks import oks as jax_oks
from detrpose_tpu.train.criterion import criterion as jax_criterion
from detrpose_tpu.train.criterion import union_indices as jax_union_indices
from detrpose_tpu.train.matcher import auction_assign as jax_auction
from detrpose_tpu.train.matcher import match_cost as jax_match_cost

from detrpose_tpu_torch.ops.oks import oks
from detrpose_tpu_torch.train.cdn import build_cdn, cdn_to_device
from detrpose_tpu_torch.train.criterion import criterion, union_indices
from detrpose_tpu_torch.train.matcher import (BIG, auction_assign, hungarian_match,
                                              match_cost, scipy_assign)

from test_torch_train_model import HW, jax_dn, synthetic_targets, train_weights

torch.set_num_threads(2)
ALL_LOSSES = ("vfl", "keypoints", "labels", "mal", "local")
ALL_WEIGHTS = {"loss_vfl": 2.0, "loss_keypoints": 10.0, "loss_oks": 4.0,
               "loss_ce": 1.5, "loss_mal": 0.5, "loss_dfl": 0.75}
ARRAY_KEYS = ("pred_logits", "pred_keypoints", "pred_corners", "teacher_corners",
              "teacher_logits")


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("K", [17, 14])
def test_oks_matches_jax(K):
    rng = np.random.default_rng(K)
    zp, zg = rng.uniform(0, 1, (2, 50, 2 * K)).astype(np.float32)
    vg = (rng.uniform(size=(50, K)) > 0.3).astype(np.float32)
    area = rng.uniform(0.01, 0.3, 50).astype(np.float32)
    want = np.asarray(jax_oks(*(jnp.asarray(a) for a in (zp, zg, vg, area)), K))
    got = oks(*(torch.from_numpy(a) for a in (zp, zg, vg, area)), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("K", [17, 14])
def test_match_cost_matches_jax(K):
    rng = np.random.default_rng(100 + K)
    t = synthetic_targets(rng, 3, 5, K, n_valid=[5, 2, 0])
    t["labels"] = rng.integers(0, 2, (3, 5)).astype(np.int32)
    logits = rng.normal(0, 3, (3, 60, 2)).astype(np.float32)
    logits[0, 0] = 30.0                    # saturated: the log's argument clamps
    kpts = rng.uniform(0, 1, (3, 60, 2 * K)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: jax_match_cost(a, b, c, K))(
        logits, kpts, jax.tree.map(jnp.asarray, t)))
    got = match_cost(torch.from_numpy(logits), torch.from_numpy(kpts), _t(t), K).numpy()
    valid = np.broadcast_to(t["valid"][:, None, :], want.shape)
    assert (got[~valid] == BIG).all() and (want[~valid] == BIG).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-6, atol=1e-6)
    # leading branch dimensions: each branch as the same call alone
    stacked = match_cost(torch.from_numpy(np.stack([logits, -logits])),
                         torch.from_numpy(np.stack([kpts, kpts[:, ::-1]])), _t(t), K)
    torch.testing.assert_close(stacked[0], torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("seed,B,nq,G", [(0, 4, 60, 8), (1, 3, 124, 20), (2, 6, 20, 5),
                                         (3, 2, 300, 32)])
def test_auction_matches_jax_and_scipy(seed, B, nq, G):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 40, (B, nq, G)).astype(np.float32)
    cost[0, :3] = 5.0                                    # ties: first index wins
    n_valid = rng.integers(0, G + 1, B)
    n_valid[0] = G
    valid = np.arange(G)[None, :] < n_valid[:, None]
    cost = np.where(valid[:, None, :], cost, BIG).astype(np.float32)
    want = np.asarray(jax.jit(jax_auction)(jnp.asarray(cost), jnp.asarray(valid)))
    got = auction_assign(torch.from_numpy(cost), torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    exact = scipy_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(np.where(valid, got.numpy(), 0), np.where(valid, exact, 0))
    for b in range(B):                                   # distinct queries per image
        q = got[b, :n_valid[b]].numpy()
        assert len(set(q.tolist())) == len(q)
    # leading branch dimensions: each branch its own problem (its own scale)
    two = np.stack([cost, np.where(valid[:, None, :], cost * 7.0, BIG)]).astype(np.float32)
    both = auction_assign(torch.from_numpy(two), torch.from_numpy(valid))
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(
        both[1].numpy(), np.asarray(jax.jit(jax_auction)(jnp.asarray(two[1]), jnp.asarray(valid))))


def test_union_indices_matches_jax():
    rng = np.random.default_rng(5)
    valid = np.array([[True] * 6, [True] * 3 + [False] * 3])
    assigns = [np.stack([rng.permutation(30)[:6] for _ in range(2)]) for _ in range(4)]
    assigns[1][0, :3] = assigns[0][0, :3]                # some agreement across layers
    want = jax_union_indices([jnp.asarray(a) for a in assigns], jnp.asarray(valid), 30)
    got = union_indices(torch.from_numpy(np.stack(assigns)).long(), torch.from_numpy(valid), 30)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.fixture(scope="module")
def jax_train_outputs():
    """N at 160 px, batch 2, one CDN batch: JAX's train outputs, the targets
    (a GT slot not valid in the second image) and the CDN batch."""
    K = 17
    jm, variables = train_weights("n", K, 20)
    rng = np.random.default_rng(20)
    targets = synthetic_targets(rng, 2, 3, K, n_valid=[3, 2])
    dn = build_cdn(targets, 60, K, (HW, HW), np.random.default_rng(120))
    x = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    out, _ = jax.jit(lambda v, im, d: jm.apply(v, im, train=True, dn=d,
                                               mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jax_dn(dn))
    return out, targets, dn


def _arrays(out):
    """The differentiable leaves of a train dict, by branch."""
    branches = {"": out, "pre": out["aux_pre_outputs"], "dn_pre": out["dn_aux_pre_outputs"],
                "interm": out["aux_interm_outputs"][0]}
    branches.update({f"aux_{i}": a for i, a in enumerate(out["aux_outputs"])})
    branches.update({f"dn_{i}": a for i, a in enumerate(out["dn_aux_outputs"])})
    return {b: {k: np.asarray(v[k], np.float32) for k in ARRAY_KEYS if k in v}
            for b, v in branches.items()}


def _rebuild(arrays, meta):
    """A train dict from its leaves (JAX arrays or torch tensors)."""
    out = dict(arrays[""], **meta)
    n_aux = sum(k.startswith("aux_") for k in arrays)
    n_dn = sum(k.startswith("dn_") and k != "dn_pre" for k in arrays)
    out["aux_outputs"] = [arrays[f"aux_{i}"] for i in range(n_aux)]
    out["dn_aux_outputs"] = [dict(arrays[f"dn_{i}"], is_dn=True) for i in range(n_dn)]
    out["aux_pre_outputs"] = arrays["pre"]
    out["dn_aux_pre_outputs"] = arrays["dn_pre"]
    out["aux_interm_outputs"] = [arrays["interm"]]
    return out


@pytest.mark.parametrize("losses", ["default", "all"])
def test_criterion_and_its_gradient_match_jax(jax_train_outputs, losses):
    out, targets, dn = jax_train_outputs
    K = 17
    kw = ({} if losses == "default" else {"losses": ALL_LOSSES, "weight_dict": ALL_WEIGHTS})
    arrays = _arrays(out)
    meta = {"up": out["up"], "reg_scale": out["reg_scale"], "reg_max": out["reg_max"],
            "dn_meta": out["dn_meta"]}
    jt = dict(jax.tree.map(jnp.asarray, targets), dn_match=jax_dn(dn)["dn_match"])

    def jax_terms(arr):
        return jax_criterion(_rebuild(arr, meta), jt, K, **kw)

    jarr = jax.tree.map(jnp.asarray, arrays)
    want = jax.jit(jax_terms)(jarr)
    want_g = jax.jit(jax.grad(lambda a: sum(jax_terms(a).values())))(jarr)

    leaves = {b: {k: torch.tensor(v, requires_grad=True) for k, v in d.items()}
              for b, d in arrays.items()}
    tdn = cdn_to_device(dn, "cpu")
    tt = dict(_t(targets), dn_match=tdn["dn_match"])
    got = criterion(_rebuild(leaves, dict(meta, dn_meta={"pad_size": 64})), tt, K, **kw)

    assert sorted(got) == sorted(want)
    n_dn = sum(k.endswith("_dn_0") for k in got)
    assert n_dn == (2 if losses == "default" else 6 - 1) + 1   # every term has a DN branch
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    torch.stack(list(got.values())).sum().backward()
    for b, d in leaves.items():
        for k, t in d.items():
            w = np.asarray(want_g[b][k])
            g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
            scale = np.abs(w).max()
            # a leaf whose gradient is 0 up to rounding (the last layer's
            # corners against themselves as teacher, ~1e-11) is held to 1e-9
            assert np.abs(g - w).max() <= 1e-5 * max(scale, 1e-4), (b, k, scale)


def test_hungarian_match_backends_agree(jax_train_outputs):
    out, targets, _ = jax_train_outputs
    lg = torch.from_numpy(np.stack([np.asarray(out["pred_logits"])] +
                                   [np.asarray(a["pred_logits"]) for a in out["aux_outputs"]]))
    kp = torch.from_numpy(np.stack([np.asarray(out["pred_keypoints"])] +
                                   [np.asarray(a["pred_keypoints"]) for a in out["aux_outputs"]]))
    t = _t(targets)
    a = hungarian_match(lg, kp, t, 17)
    s = hungarian_match(lg, kp, t, 17, backend="scipy")
    assert a.shape == (3, 2, 3)
    np.testing.assert_array_equal(np.where(targets["valid"], a.numpy(), 0),
                                  np.where(targets["valid"], s.numpy(), 0))
    with pytest.raises(ValueError, match="backend"):
        hungarian_match(lg, kp, t, 17, backend="lapjv")
