"""The port's Trainer, checkpoints and training command line on the CPU.

N at 160 px, float32, 4 train and 4 val images of ``tests/synth_data.py``,
batch 2. From the same weights (carried by ``from_jax_variables``):
``Trainer.evaluate`` equals JAX's ``Trainer.evaluate``, every stat to 1e-6,
on a val ground truth made from the port's own detections (the top two an
image, moved by 0-6 px), so the stats are neither 0 nor 1; and one epoch's
training statistics (``train_one_epoch``, the training part of ``fit``: two
steps with CDN) give every loss term within 1e-3 relative of JAX's, the two
steps' float32 drift (tests/test_torch_train_step.py holds one step's loss
to 1e-4).

A checkpoint round trip restores the model, the EMA with its BN statistics,
the AdamW state, the accumulated gradients, the counters and the epoch bit for
bit, and ``evaluate`` gives the same detections; an optimiser-state mismatch
keeps the weights and warns. ``fit`` writes ``checkpoint`` every epoch and
``best``, ``best_ema`` and ``best_regular`` on a new best of their stream
(the reference's rule: a stream's first best needs AP > 0). A non-finite
loss stops the epoch. ``load_torch_weights`` takes a zoo ``.pth`` (EMA
preferred). The command line is tested in tests/test_torch_train_cli.py.
"""
import json

import numpy as np
import pytest
import torch

from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.data import coco as jcoco
from detrpose_tpu.data import loader as jloader
from detrpose_tpu.data import transforms as jtf
from detrpose_tpu.train.trainer import Trainer as JTrainer

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.data import coco, loader, transforms as tf
from detrpose_tpu_torch.tools.train import val_ground_truth
from detrpose_tpu_torch.train.trainer import Trainer
from detrpose_tpu_torch.utils.checkpoint import restore_variables
from detrpose_tpu_torch.utils.convert import from_jax_variables

from synth_data import make_tiny_coco
from test_torch_train_model import train_weights

torch.set_num_threads(2)
HW, K = 160, 17
PORT, JAX = (coco, tf, loader), (jcoco, jtf, jloader)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    train = make_tiny_coco(str(root / "train"), n_images=6, w=HW, h=HW, seed=1,
                           draw=True, structured=True)
    val = make_tiny_coco(str(root / "val"), n_images=4, w=HW, h=120, seed=2,
                         draw=True, structured=True)
    return train, val


def loaders(data, modules, n_train=4):
    """(train loader, val loader, val dataset) of one package's data
    modules: train on the first ``n_train`` images without the heavy
    augmentations (hflip and colour jitter still draw), CDN on."""
    C, T, L = modules
    (img_dir, ann), (vdir, vann) = data
    tds = C.CocoKeypointDataset(img_dir, ann, K, train=True, transforms=T.TrainTransforms(
        out_size=HW, num_keypoints=K, policy_epochs=(99, 100, 101)))
    tds.ids = tds.ids[:n_train]
    vds = C.CocoKeypointDataset(vdir, vann, K, transforms=T.EvalTransforms(out_size=HW))
    return (L.KeypointLoader(tds, batch_size=2, num_keypoints=K, train=True, base_size=HW),
            L.KeypointLoader(vds, batch_size=2, num_keypoints=K, with_cdn=False,
                             drop_last=False), vds)


def port_trainer(data, out_dir, variables=None, n_train=4, size_seed=0, **kw):
    """A port Trainer of N on the CPU in float32: weights from ``variables``
    (JAX's) or drawn from ``size_seed``."""
    model = build_model(model_config("n"), device="cpu",
                        generator=torch.Generator().manual_seed(size_seed))
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables), strict=True)
    tl, vl, vds = loaders(data, PORT, n_train)
    kw = dict(dict(output_dir=str(out_dir), epochs=1, tensorboard=False), **kw)
    return Trainer(model, model_config("n"), tl, vl, val_ground_truth(vds, K),
                   compute_dtype=torch.float32, device="cpu", **kw)


def pseudo_ground_truth(trainer, seed=0):
    """A val ground truth made of the trainer's own two best detections an
    image, moved by 0-6 px (area: their keypoint box, x2)."""
    rng = np.random.default_rng(seed)
    gts = {}
    for ids, scores, kpts in trainer._detections(use_ema=True):
        for img_id, s, k in zip(ids, scores, kpts):
            anns = []
            for j in np.argsort(-s)[:2]:
                kp = k[j].astype(np.float64).copy()
                kp[:, :2] += rng.uniform(0, 6, (K, 1)) * rng.normal(size=(K, 2))
                kp[:, 2] = 2
                x0, y0 = kp[:, :2].min(0)
                w, h = kp[:, :2].max(0) - (x0, y0)
                anns.append({"keypoints": kp, "area": float(2 * w * h),
                             "bbox": [x0, y0, w, h], "iscrowd": 0, "num_keypoints": K})
            gts[int(img_id)] = {"anns": anns}
    return gts


def test_evaluate_and_one_epoch_match_jax(data, tmp_path):
    jm, variables = train_weights("n", K, seed=20)
    jtl, jvl, _ = loaders(data, JAX)
    jt = JTrainer(jm, jax_model_config("n"), jtl, jvl, {}, output_dir=str(tmp_path / "jax"),
                  epochs=1, tensorboard=False, n_devices=1, prewarm_scales=False)
    jt.state = jt.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        ema=dict(jt.state.ema, params=variables["params"],
                 batch_stats=variables["batch_stats"]))
    pt = port_trainer(data, tmp_path / "port", variables)
    gts = pseudo_ground_truth(pt)
    jt.val_gts = pt.val_gts = gts
    for use_ema in (True, False):
        want, got = jt.evaluate(use_ema=use_ema), pt.evaluate(use_ema=use_ema)
        assert got.keys() == want.keys()
        assert 0.05 < want["AP"] < 0.95, want
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])

    want, got = jt.train_one_epoch(0), pt.train_one_epoch(0)
    losses = [k for k in want if k.startswith("loss_")]
    assert len(losses) > 20 and any("_dn_" in k for k in losses)
    assert set(want) - {"step_ms"} <= set(got)
    assert got["finite"] == want["finite"] == 1.0
    for k in losses:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-7, (k, got[k], want[k])


def _state(tr):
    """Every piece of a trainer's training state, as CPU tensors."""
    opt = tr.optimizer.adamw
    names = {id(p): n for n, p in tr.model.named_parameters()}
    adamw = {names[id(p)] + "." + k: (v.clone() if torch.is_tensor(v) else v)
             for p, st in opt.state.items() for k, v in st.items()}
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters() if p.grad is not None}
    return {"model": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in tr.step.ema.state_dict().items()},
            "adamw": adamw, "grads": grads,
            "counters": (tr.step.step, tr.step.micro, tr.optimizer.updates,
                         tr.step.ema.updates)}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys(), k
            for n in a[k]:
                va, vb = a[k][n], b[k][n]
                assert (torch.equal(va, vb) if torch.is_tensor(va) else va == vb), (k, n)
        else:
            assert a[k] == b[k], k


def test_checkpoint_round_trip(data, tmp_path):
    # 6 images, batch 2, accumulation 2: one optimiser step and one
    # micro-batch of gradients pending at the epoch's end
    tr = port_trainer(data, tmp_path / "a", n_train=6, grad_accum_steps=2)
    tr.fit()
    saved = _state(tr)
    assert saved["counters"] == (3, 1, 1, 1) and saved["grads"] and saved["adamw"]
    fresh = port_trainer(data, tmp_path / "b", n_train=6, grad_accum_steps=2, size_seed=5)
    assert any(not torch.equal(v, saved["model"][k])
               for k, v in fresh.model.state_dict().items())
    fresh.resume(str(tmp_path / "a" / "checkpoint"))
    assert fresh.start_epoch == 1
    _assert_same(_state(fresh), saved)
    # the inference path: the EMA weights (or the live ones), no optimiser
    for prefer_ema, key in ((True, "ema"), (False, "model")):
        _assert_same({"w": restore_variables(str(tmp_path / "a" / "checkpoint"), prefer_ema)},
                     {"w": saved[key]})
    for use_ema in (True, False):
        assert fresh.evaluate(use_ema) == tr.evaluate(use_ema)
        assert fresh.evaluator.dets.keys() == tr.evaluator.dets.keys()
        for img, dets in tr.evaluator.dets.items():
            for d, e in zip(dets, fresh.evaluator.dets[img], strict=True):
                assert d["score"] == e["score"]
                np.testing.assert_array_equal(d["keypoints"], e["keypoints"])

    # another optimiser (the backbone frozen): the weights and EMA load,
    # the optimiser starts fresh, with a warning
    other = port_trainer(data, tmp_path / "c", n_train=6, grad_accum_steps=2,
                         freeze_backbone=True)
    with pytest.warns(UserWarning, match="optimizer state"):
        other.resume(str(tmp_path / "a" / "checkpoint"))
    got = _state(other)
    _assert_same({k: got[k] for k in ("model", "ema")},
                 {k: saved[k] for k in ("model", "ema")})
    assert not got["adamw"] and not got["grads"] and other.step.micro == 0


def test_fit_writes_best_checkpoints(data, tmp_path, monkeypatch):
    tr = port_trainer(data, tmp_path, n_train=2, epochs=4)
    # scripted epochs: no training, and APs of the EMA and the live weights
    aps = iter([0.0, 0.0, 0.2, 0.1, 0.1, 0.3, 0.15, 0.05])
    monkeypatch.setattr(tr, "train_one_epoch", lambda epoch: {"loss_total": 1.0})
    monkeypatch.setattr(tr, "evaluate", lambda use_ema=None: {"AP": next(aps)})
    assert tr.fit() == 0.2
    epochs = {name: torch.load(tmp_path / name, weights_only=False)["epoch"]
              for name in ("checkpoint", "best", "best_ema", "best_regular")}
    assert epochs == {"checkpoint": 3, "best": 1, "best_ema": 1, "best_regular": 2}
    log = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in log] == [0, 1, 2, 3]
    assert log[-1]["ema_best_ep"] == 1 and log[-1]["regular_best_ep"] == 2
    assert log[-1]["all_best_res"] == 0.3


def test_non_finite_loss_stops_training(data, tmp_path, monkeypatch):
    # the step skips a non-finite update; the epoch then stops with the
    # reference's error (engine.py:68-71)
    tr = port_trainer(data, tmp_path, n_train=2)
    nan = {"loss_total": torch.tensor(float("nan")), "finite": False, "step": 1}
    monkeypatch.setattr(tr, "step", lambda batch: nan)
    with pytest.raises(RuntimeError, match="stopping training"):
        tr.train_one_epoch(0)


def test_load_torch_weights_takes_a_zoo_checkpoint(data, tmp_path):
    # the reference .pth layout ({"model", "ema": {"module"}}, with a derived
    # tensor the port recomputes): the EMA weights load into the model and
    # the EMA, or the live ones with prefer_ema=False
    tr = port_trainer(data, tmp_path, n_train=2)
    live = build_model(model_config("n"), device="cpu",
                       generator=torch.Generator().manual_seed(1)).state_dict()
    ema = build_model(model_config("n"), device="cpu",
                      generator=torch.Generator().manual_seed(2)).state_dict()
    torch.save({"model": dict(live, **{"transformer.decoder.up": torch.ones(1)}),
                "ema": {"module": ema, "updates": 5}}, tmp_path / "zoo.pth")
    for prefer_ema, want in ((True, ema), (False, live)):
        tr.load_torch_weights(str(tmp_path / "zoo.pth"), prefer_ema=prefer_ema)
        _assert_same({"model": tr.model.state_dict(), "ema": tr.step.ema.state_dict()},
                     {"model": want, "ema": want})
