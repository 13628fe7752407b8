"""The overfit tool (``tools/overfit.py``, the counterpart of
tools_local_overfit.py) on the CPU.

Its drawn set comes from the package's copy of the generator
(``data/synthetic.py``), which must write what tests/synth_data.py writes
for the same arguments: the same annotation file and the same JPEG bytes.
A 3-step N run (160 px, 8 images, batch 4) through the loader, CDN,
matcher, criterion, AdamW, EMA, postprocess and evaluator gives finite
losses and the evaluator's 10 stats for both streams, train and held out.
"""
import os

import pytest

from detrpose_tpu_torch.data.synthetic import make_tiny_coco
from detrpose_tpu_torch.tools.overfit import overfit

from synth_data import make_tiny_coco as reference_make_tiny_coco

STATS = {"AP", "AP50", "AP75", "AP_medium", "AP_large", "AR", "AR50", "AR75", "AR_medium",
         "AR_large"}


@pytest.mark.parametrize("kwargs", [
    dict(n_images=5, w=160, h=160, people=2, draw=True, structured=True),
    dict(n_images=3, w=160, h=160, people=2, seed=123, draw=True, structured=True),
    dict(n_images=3, K=14, people=3, draw=True),
    dict(n_images=2),
])
def test_synthetic_copy_matches_the_tests_generator(tmp_path, kwargs):
    got = make_tiny_coco(str(tmp_path / "port"), **kwargs)
    want = reference_make_tiny_coco(str(tmp_path / "ref"), **kwargs)
    with open(got[1], "rb") as a, open(want[1], "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(want[0]))
    assert sorted(os.listdir(got[0])) == names and len(names) == kwargs["n_images"]
    for f in names:
        with open(os.path.join(got[0], f), "rb") as a, open(os.path.join(want[0], f),
                                                             "rb") as b:
            assert a.read() == b.read(), f


def test_three_step_run(tmp_path):
    lines = []
    r = overfit(steps=3, n_images=8, stage_epochs=1, batch=4, sample_every=1, holdout=4,
                root=str(tmp_path), device="cpu", log=lines.append)
    assert r["finite"] and [s for s, _ in r["curve"]] == [1, 2, 3]
    assert r["batches"] == 2 and r["decay_at"] == 2
    assert r["eval_batches"] == 2 * (2 + 1)       # 8 train images at 4, 4 held out at 8
    assert set(r["stats"]) == {"regular", "ema", "held-out, regular", "held-out, ema"}
    for name, stats in r["stats"].items():
        assert set(stats) == STATS, name
    assert r["verdict"] in ("LEARNS", "WEAK")
    assert lines[-1].startswith(f"VERDICT: {r['verdict']}")


def test_init_from_the_jax_recipe(tmp_path):
    """``--init``: the JAX recipe's initial state, written by JAX, is where
    the port's run starts, leaf for leaf (not seed 0's draw)."""
    import torch

    from detrpose_tpu_torch.tools.overfit import initial_model
    from detrpose_tpu_torch.utils.convert import drop_derived, load_torch_checkpoint

    from jax_overfit_init import save_jax_overfit_init

    path = str(tmp_path / "jax_init")
    save_jax_overfit_init(path)
    want = drop_derived(load_torch_checkpoint(path, prefer_ema=False))
    got = initial_model(0, path, torch.device("cpu")).state_dict()
    drawn = initial_model(0, None, torch.device("cpu")).state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert any(not torch.equal(drawn[k], got[k]) for k in want if got[k].is_floating_point())
    r = overfit(steps=1, n_images=4, stage_epochs=1, batch=4, sample_every=1, holdout=4,
                init=path, root=str(tmp_path / "sets"), device="cpu", log=lambda m: None)
    assert r["finite"]
