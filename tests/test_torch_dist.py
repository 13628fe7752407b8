"""The port's data parallelism over ranks on the CPU, against one process
and against the JAX package.

Ranks are spawned processes joined over gloo on a fresh localhost port
(``parallel/dist.py::run_ranks``); each spawn has its own deadline of at most
120 s, after which every rank is killed and the test fails, so a hang cannot
hold the suite. Their code is in ``tests/torch_dist_ranks.py``.

N at 160 px. In-process: ``shard_indices``, ``gather_lists`` and
``merge_detections`` against the JAX functions with an injected gather, bit
for bit, for 1-4 ranks. One spawn of 2 ranks (``core``) then checks:
  * the same two functions through ``all_gather_object``;
  * SyncBN: forward, input gradient, affine gradients (summed over the
    ranks) and running statistics against one process's BatchNorm on the
    whole batch (1e-6), the running variance the biased one;
  * the CDN group count when the ranks' largest GT counts differ: every
    rank sizes its CDN block for the global batch's;
  * one optimiser step (accumulation 2, 2 images a rank a micro-step)
    against one process on the global batch, in float64: the global loss to
    1e-5 relative, parameters, EMA and BN statistics to 1e-6, the ranks bit
    for bit equal (in float32 AdamW's first step, lr * g / (|g| + eps), makes
    a step of +-lr of the rounding of a gradient that cancels to ~0: the
    float32 gradients are held to JAX's below);
  * the skip when one rank's loss alone is non-finite: every rank skips
    and keeps its state, and training goes on as if the micro-batch had not
    been;
  * one step (1 image a rank) against JAX ``make_train_step`` on the global
    batch, to tests/test_torch_train_step.py's limits and named leaves, and
    in float64 against one process in float64.
A second spawn runs ``Trainer.fit`` for one epoch, ``evaluate`` and
``test`` (5 val images: the wrap-padded shards evaluate one twice); a third
the command line under ``torch.distributed.run --nproc_per_node 2 --device
cpu``.
"""
import json
import os
import pickle
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detrpose_tpu.parallel.dist import gather_lists as jax_gather_lists
from detrpose_tpu.parallel.dist import merge_detections as jax_merge_detections
from detrpose_tpu.parallel.dist import shard_indices as jax_shard_indices
from detrpose_tpu.parallel.train_step import TrainState
from detrpose_tpu.parallel.train_step import make_train_step as jax_make_train_step

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.data.loader import shard_indices
from detrpose_tpu_torch.models.layers import BatchNorm
from detrpose_tpu_torch.parallel.dist import free_port, gather_lists, merge_detections, run_ranks
from detrpose_tpu_torch.train.cdn import build_cdn
from detrpose_tpu_torch.train.trainer import Trainer
from detrpose_tpu_torch.utils.convert import from_jax_variables

import torch_dist_ranks as ranks
from synth_data import make_tiny_coco
from test_torch_data import write_set
from test_torch_train_model import HW, jax_dn, synthetic_targets, train_weights
from test_torch_train_step import ILL_CONDITIONED, JAX_DRIFT, _batch, _port_batch

torch.set_num_threads(2)
K = 17
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120.0


def fake_allgather(payloads):
    return lambda _mine: [pickle.dumps(p) for p in payloads]


def per_rank_results(world):
    """Each rank's detections (image id -> list) and results.json items, the
    images of a wrap-padded shard of 7 over ``world`` ranks."""
    rng = np.random.default_rng(world)
    dets, lists = [], []
    for r in range(world):
        ids = shard_indices(list(range(7)), r, world)
        dets.append({i: [{"score": float(rng.uniform()), "keypoints": rng.normal(size=(K, 3))}]
                     for i in ids})
        lists.append([{"image_id": i, "score": float(rng.uniform())} for i in ids for _ in
                      range(2)])
    return dets, lists


def same(a, b):
    """Equality of nested dicts and lists of floats and numpy arrays."""
    return pickle.dumps(a) == pickle.dumps(b)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_gather_merge_match_jax(world):
    order = list(np.random.default_rng(0).permutation(23))
    for r in range(world):
        assert shard_indices(order, r, world) == jax_shard_indices(order, r, world)
    dets, lists = per_rank_results(world)
    key = lambda item: item["image_id"]   # noqa: E731
    for r in range(world):
        assert same(merge_detections(dets[r], fake_allgather(dets)),
                    jax_merge_detections(dets[r], fake_allgather(dets)))
        for dedup in (None, key):
            assert same(gather_lists(lists[r], fake_allgather(lists), dedup),
                        jax_gather_lists(lists[r], fake_allgather(lists), dedup))
    # without a process group the functions return their input
    assert merge_detections(dets[0]) is dets[0]
    assert gather_lists(lists[0]) == lists[0]


def _targets(rng, n_valid):
    return synthetic_targets(rng, len(n_valid), 4, K, n_valid=n_valid)


def _global_batch(rng, B):
    """A port training batch of B images at HW px with its CDN block."""
    targets = _targets(rng, [int(v) for v in rng.integers(1, 4, B)])
    dn = build_cdn(targets, 60, K, (HW, HW), rng)
    x = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    return _port_batch(targets, dn, x)


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """The inputs of ``torch_dist_ranks.core``, both ranks' results, and the
    one-process and JAX references."""
    work = str(tmp_path_factory.mktemp("core"))
    rng = np.random.default_rng(90)
    jm, variables = train_weights("n", K, 20)
    sd = from_jax_variables(variables)
    dets, lists = per_rank_results(2)
    bn = BatchNorm(6)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(0, 0.5, 6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
    targets, dn, x = _batch(20)
    inp = {"dets": dets, "lists": lists,
           "bn_state": {k: v.clone() for k, v in bn.state_dict().items()},
           "bn_x": torch.from_numpy((rng.normal(size=(4, 6, 5, 3)) * 2 + 0.5)
                                    .astype(np.float32)),
           "bn_w": torch.from_numpy(rng.normal(size=(4, 6, 5, 3)).astype(np.float32)),
           "cdn_targets": [_targets(rng, [3, 1]), _targets(rng, [1, 2])], "hw": HW,
           "sd": sd, "micro": [_global_batch(rng, 4) for _ in range(2)],
           "jax_sd": sd, "jax_batch": _port_batch(targets, dn, x)}
    torch.save(inp, os.path.join(work, "inputs.pt"))
    run_ranks(ranks.core, 2, (work,), deadline_s=DEADLINE_S)
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return {"inp": inp, "got": got, "variables": variables, "jm": jm,
            "jax_inputs": (targets, dn, x), "bn": bn}


def test_gather_and_merge_through_two_ranks(core):
    dets, lists = core["inp"]["dets"], core["inp"]["lists"]
    want_dets = jax_merge_detections(dets[0], fake_allgather(dets))
    want_lists = jax_gather_lists(lists[0], fake_allgather(lists), lambda r: r["image_id"])
    assert sorted(want_dets) == list(range(7))
    for got in core["got"]:
        assert same(got["merged"], want_dets) and same(got["gathered"], want_lists)


def test_sync_batchnorm_two_ranks(core):
    inp, bn = core["inp"], core["bn"]
    x = inp["bn_x"].clone().requires_grad_()
    y = bn.train()(x)
    (y * inp["bn_w"]).sum().backward()
    got = core["got"]
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-6)  # noqa: E731
    close(torch.cat([g["bn"]["y"] for g in got]), y.detach())
    close(torch.cat([g["bn"]["grad"] for g in got]), x.grad)
    # each rank's affine gradient is its share (DDP sums them)
    close(got[0]["bn"]["weight_grad"] + got[1]["bn"]["weight_grad"], bn.weight.grad)
    close(got[0]["bn"]["bias_grad"] + got[1]["bn"]["bias_grad"], bn.bias.grad)
    for g in got:
        close(g["bn"]["mean"], bn.running_mean)
        close(g["bn"]["var"], bn.running_var)
        assert torch.equal(g["bn"]["var"], got[0]["bn"]["var"])
    # the biased variance of the 60 values a channel (30 a rank), as Flax's:
    # not the unbiased one torch folds in
    xs = inp["bn_x"].double()
    var = xs.var(dim=(0, 2, 3), unbiased=False)
    rv0 = inp["bn_state"]["running_var"].double()
    torch.testing.assert_close(got[0]["bn"]["var"].double(), 0.9 * rv0 + 0.1 * var,
                               rtol=0, atol=1e-6)


def test_group_count_is_the_global_batchs(core):
    # rank 0's largest GT count is 3, rank 1's 2: both build 6 groups of 3,
    # the global batch's, as one process builds them
    t = core["inp"]["cdn_targets"]
    glob = {k: np.concatenate([t[0][k], t[1][k]]) for k in t[0]}
    want = build_cdn(glob, 60, K, (HW, HW), np.random.default_rng(0))
    alone = build_cdn(t[1], 60, K, (HW, HW), np.random.default_rng(1))
    assert want["num_dn_group"] == 6 and alone["num_dn_group"] == 10
    for g in core["got"]:
        assert g["cdn"]["num_dn_group"] == want["num_dn_group"]
        assert float(g["cdn"]["num_group"]) == float(want["dn_match"]["num_group"])
        np.testing.assert_array_equal(g["cdn"]["attn_mask"], want["attn_mask"])


@pytest.fixture(scope="module")
def one_process(core):
    """One process over the global micro-batches in float64: the metrics of
    the first two micro-steps (one optimiser step) and the state after them
    and after two more."""
    inp = core["inp"]
    step = ranks.new_step(inp["sd"], 2, dtype=torch.float64, ema_decay=0.9, ema_warmups=2)
    metrics = [step(ranks.in64(b)) for b in inp["micro"]]
    first = ranks.state(step)
    for b in inp["micro"]:
        step(ranks.in64(b))
    return {"metrics": metrics, "first": first, "second": ranks.state(step)}


def _assert_state_close(got, want, atol):
    for part in ("params", "buffers", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, w in want[part].items():
            torch.testing.assert_close(got[part][k], w, rtol=0, atol=atol, msg=f"{part} {k}")


def _assert_ranks_equal(a, b):
    for part in ("params", "buffers", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part


def test_two_rank_step_matches_one_process(core, one_process):
    inp, got, metrics = core["inp"], core["got"], one_process["metrics"]
    for g in got:
        assert g["updates"] == (1, 1, 0)
        for m_got, m_want in zip(g["losses"], metrics):
            assert m_got.keys() == {k for k, v in m_want.items() if torch.is_tensor(v)}
            for k, v in m_got.items():
                assert abs(v - m_want[k].item()) <= 1e-5 * abs(m_want[k].item()) + 1e-9, k
        _assert_state_close(g["state"], one_process["first"], 1e-6)
    _assert_ranks_equal(got[0]["state"], got[1]["state"])
    # BN statistics moved, by the global batch's (biased) statistics
    assert not torch.equal(got[0]["state"]["buffers"]["encoder.input_proj.0.norm.running_var"],
                           inp["sd"]["encoder.input_proj.0.norm.running_var"])


def test_skip_when_one_rank_is_non_finite(core, one_process):
    got = core["got"]
    for g in got:
        assert g["skip"]["finite"] is False and not np.isfinite(g["skip"]["loss"])
        assert g["skip"]["kept"] and g["skip"]["counts"] == (1, 1, 1)
    # the skipped micro-batch did not count: two optimiser steps of the
    # same four micro-batches as one process
    for g in got:
        _assert_state_close(g["after_skip"], one_process["second"], 1e-6)
    _assert_ranks_equal(got[0]["after_skip"], got[1]["after_skip"])


def test_two_rank_step_matches_jax(core):
    # as tests/test_torch_train_step.py::test_one_step_matches_jax, the port
    # being 2 ranks of one image each: the JAX step on the global batch is
    # the mesh step's semantics. Every leaf within 1e-3 of its max|g| of
    # JAX's, but for the named leaves, whose float32 gradient is
    # ill-conditioned at this seed; each of those is held to JAX at 5e-2 in
    # relative L2 norm (or 1e-6 of the largest |g|). The 2 ranks in float64
    # give one process's float64 gradients (the witness) to 1e-6 of each
    # leaf's max|g| (or 1e-9 of the largest, where a leaf cancels to 0): the
    # ranks compute the same function, the named leaves' spread is rounding.
    targets, dn, x = core["jax_inputs"]
    variables = core["variables"]
    tx = optax.GradientTransformation(
        lambda p: {"grads": jax.tree.map(jnp.zeros_like, p)},
        lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), {"grads": g}))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, metrics = jax.jit(jax_make_train_step(core["jm"], tx, K, use_ema=False))(
        state, {"images": jnp.asarray(x), "targets": jax.tree.map(jnp.asarray, targets),
                "dn": jax_dn(dn)})
    assert bool(metrics["finite"])
    want = from_jax_variables(
        {"params": jax.tree.map(np.asarray, new_state.opt_state["grads"])})
    witness = ranks.new_step(core["inp"]["sd"], 1, dtype=torch.float64, use_ema=False)
    ranks.capture_grads(witness)
    assert witness(ranks.in64(_port_batch(targets, dn, x)))["finite"]
    named = set(ILL_CONDITIONED + JAX_DRIFT)
    top = max(w.abs().max().item() for w in want.values())
    top64 = max(w.abs().max().item() for w in witness.grads.values())
    for g in core["got"]:
        np.testing.assert_allclose(g["jax_step_float32"]["loss"], float(metrics["loss_total"]),
                                   rtol=1e-4)
        grads, grads64 = g["jax_step_float32"]["grads"], g["jax_step_float64"]["grads"]
        assert grads.keys() == grads64.keys() == witness.grads.keys()
        bad = []
        for name, w in want.items():
            w, gr = w.numpy(), grads[name].numpy()
            if name in named:
                ok = np.linalg.norm(gr - w) <= 5e-2 * np.linalg.norm(w) + 1e-6 * top
            else:
                ok = np.abs(gr - w).max() <= 1e-3 * np.abs(w).max()
            h = witness.grads[name]
            ok &= ((grads64[name] - h).abs().max().item()
                   <= 1e-6 * h.abs().max().item() + 1e-9 * top64)
            if not ok:
                bad.append((name, np.abs(gr - w).max() / np.abs(w).max()))
        assert not bad, bad
    for key in ("jax_step_float32", "jax_step_float64"):
        a, b = (g[key]["grads"] for g in core["got"])
        assert all(torch.equal(a[k], b[k]) for k in a), key


@pytest.fixture(scope="module")
def tiny_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sets")
    return (make_tiny_coco(str(root / "train"), n_images=4, w=HW, h=HW, seed=1, draw=True,
                           structured=True),
            make_tiny_coco(str(root / "val"), n_images=5, w=HW, h=120, seed=2, draw=True,
                           structured=True))


def test_trainer_fit_and_evaluate_two_ranks(tiny_sets, tmp_path):
    from detrpose_tpu_torch.data.coco import CocoKeypointDataset
    from detrpose_tpu_torch.data.loader import KeypointLoader
    from detrpose_tpu_torch.data.transforms import EvalTransforms
    from detrpose_tpu_torch.tools.train import val_ground_truth

    work = str(tmp_path)
    run_ranks(ranks.trainer_fit, 2, (work, tiny_sets + (HW,)), deadline_s=DEADLINE_S)
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    # 4 images, 2 a rank a step: one step each; the ranks in sync
    assert [g["steps"] for g in got] == [1, 1]
    _assert_ranks_equal(got[0]["state"], got[1]["state"])
    assert got[0]["stats"] == got[1]["stats"] and same(got[0]["dets"], got[1]["dets"])
    # the 5 val images once each, though rank 1 evaluated one of them too
    with open(tiny_sets[1][1]) as f:
        assert sorted(got[0]["dets"]) == sorted(im["id"] for im in json.load(f)["images"])
    # rank 0 alone wrote files; results.json holds every image's 60
    # detections once
    r0, r1 = (os.path.join(work, f"rank{r}") for r in range(2))
    written = set(os.listdir(r0))
    assert {"log.txt", "checkpoint", "best", "eval", "tb", "results.json"} <= written
    assert os.listdir(r1) == []
    with open(os.path.join(r0, "results.json")) as f:
        results = json.load(f)
    ids = [r["image_id"] for r in results]
    assert sorted(set(ids)) == sorted(got[0]["dets"]) and len(ids) == 60 * len(set(ids))
    with open(os.path.join(r0, "log.txt")) as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and np.isfinite(log[0]["train_loss_total"])
    # one process evaluating the checkpoint's weights gives the same stats
    vdir, vann = tiny_sets[1]
    vds = CocoKeypointDataset(vdir, vann, K, transforms=EvalTransforms(out_size=HW))
    cfg = model_config("n")
    tr = Trainer(build_model(cfg, device="cpu"), cfg,
                 val_loader=KeypointLoader(vds, 2, K, with_cdn=False, drop_last=False),
                 val_gts=val_ground_truth(vds, K), output_dir=str(tmp_path / "one"),
                 tensorboard=False, compute_dtype=torch.float32, device="cpu")
    tr.resume(os.path.join(r0, "checkpoint"))
    assert tr.evaluate() == got[0]["stats"]
    assert tr.evaluator.dets.keys() == got[0]["dets"].keys()


def test_cli_under_torchrun_two_ranks(tmp_path):
    img_dir, ann = write_set(tmp_path / "data", K, n_images=4, w=HW, h=HW)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "-m", "detrpose_tpu_torch.tools.train",
           "--config", os.path.join(REPO, "configs/coco/detrpose_n.py"), "--device", "cpu",
           "--img-dir", img_dir, "--ann", ann, "--val-img-dir", img_dir, "--val-ann", ann,
           "--output-dir", str(out), "--batch-size", "4", "--epochs", "1", "--options",
           f"training_params.base_size={HW}", "training_params.eval_batch_size=2",
           "training_params.num_workers=0", "training_params.policy_epochs=[0,1,101]",
           "training_params.base_size_repeat=None"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"torch.distributed.run did not end within {DEADLINE_S:.0f} s")
    assert proc.returncode == 0, log[-4000:]
    with open(out / "log.txt") as f:
        lines = [json.loads(line) for line in f]
    # one line, written once (by rank 0), of a step of 2 images a rank
    assert len(lines) == 1 and np.isfinite(lines[0]["train_loss_total"]) and "AP" in lines[0]
    assert {"checkpoint", "best", "config.yaml"} <= set(os.listdir(out))
    assert log.count("eval: ") == 2   # the EMA and the live weights, rank 0 only
