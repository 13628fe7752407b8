"""The port's training command line on the CPU.

``tools/train.py::main`` with ``--device cpu`` trains COCO N and CrowdPose N
(14 keypoints, box-area OKS, AP easy/medium/hard) one epoch each at 160 px,
batch 2, with a worker pool of 2, on the synthetic sets of
tests/test_torch_data.py. It writes ``log.txt`` with the JAX package's keys,
``checkpoint`` and ``best`` (``best_ema`` and ``best_regular`` exactly when
their stream's AP passed 0, the reference's rule) and a ``config.yaml`` that
YAML reads back equal to the resolved config; ``--eval --resume checkpoint``
prints the logged EMA stats exactly, ``--test`` writes results.json. Without
a card the entry points raise unless asked for the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.core import L, LazyConfig, instantiate, locate
from detrpose_tpu_torch.tools.train import main
from detrpose_tpu_torch.train.trainer import Trainer

from test_torch_data import write_set

torch.set_num_threads(2)
HW = 160
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_log_keys(train_keys, stats_keys):
    """The keys of a log.txt line of the JAX Trainer.fit with EMA and the
    regular stream (detrpose_tpu/train/trainer.py:626-632)."""
    best = {f"{s}_{k}" for s in ("all", "regular", "ema") for k in ("best_res", "best_ep")}
    return ({"epoch"} | {f"train_{k}" for k in train_keys} | set(stats_keys)
            | {f"regular_{k}" for k in stats_keys} | best)


def run_cli(capsys, config, args, options):
    main(["--config", os.path.join(REPO, config), "--device", "cpu"] + args
         + ["--options"] + options)
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("K,config", [(17, "configs/coco/detrpose_n.py"),
                                      (14, "configs/crowdpose/detrpose_n.py")],
                         ids=["coco", "crowdpose"])
def test_cli_trains_evaluates_and_resumes(tmp_path, capsys, K, config):
    img_dir, ann = write_set(tmp_path / "data", K, n_images=4, w=HW, h=HW)
    out = tmp_path / "out"
    common = ["--output-dir", str(out), "--batch-size", "2", "--val-img-dir", img_dir,
              "--val-ann", ann]
    options = [f"training_params.base_size={HW}", "training_params.eval_batch_size=2",
               "training_params.num_workers=2", "training_params.policy_epochs=[0,1,101]",
               "training_params.base_size_repeat=None"]
    run_cli(capsys, config, ["--img-dir", img_dir, "--ann", ann, "--epochs", "1"] + common,
            options)
    (rec,) = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    stats = {k: v for k, v in rec.items() if k[0] == "A"}
    train = [k[6:] for k in rec if k.startswith("train_")]
    assert set(rec) == jax_log_keys(train, stats)
    assert {"loss_total", "finite", "epoch_s", "lr", "lr_backbone"} <= set(train)
    assert np.isfinite(rec["train_loss_total"]) and rec["train_finite"] == 1.0
    crowd = {"AP_easy", "AP_medium", "AP_hard"}
    assert crowd <= set(stats) if K == 14 else "AP_large" in stats
    for name in ("checkpoint", "best"):
        assert torch.load(out / name, weights_only=False)["epoch"] == 0
    # best_ema / best_regular: only on a stream's AP > 0
    assert (out / "best_ema").exists() == (rec["ema_best_ep"] == 0)
    assert (out / "best_regular").exists() == (rec["regular_best_ep"] == 0)
    cfg = LazyConfig.load(os.path.join(REPO, config))
    LazyConfig.apply_overrides(cfg, options)
    cfg.training_params.update(output_dir=str(out), total_batch_size=2, epochs=1)
    with open(out / "config.yaml") as f:
        assert yaml.safe_load(f) == cfg
    assert LazyConfig.load(str(out / "config.yaml")) == cfg

    *_, printed = run_cli(capsys, config, ["--eval", "--resume", str(out / "checkpoint")]
                          + common, options)
    assert printed == stats
    run_cli(capsys, config, ["--test", "--resume", str(out / "checkpoint")] + common, options)
    results = json.loads((out / "results.json").read_text())
    assert len(results) == 4 * 60 and len(results[0]["keypoints"]) == 3 * K


def test_lazy_config_matches_jax(tmp_path):
    # the configs load as the JAX package's loader loads them; overrides,
    # deferred calls and their JSON snapshot
    from detrpose_tpu.core.lazy import LazyConfig as JLazyConfig

    for name in ("coco/detrpose_l.py", "crowdpose/detrpose_n.py"):
        path = os.path.join(REPO, "configs", name)
        got, want = LazyConfig.load(path), JLazyConfig.load(path)
        assert got == want and got.training_params.lr == want.training_params.lr
        ovr = ["training_params.epochs=3", "model_overrides.dec_n_points=8",
               "training_params.output_dir=out/x"]
        assert LazyConfig.apply_overrides(got, ovr) == JLazyConfig.apply_overrides(want, ovr)
    cfg = {"net": L(np.linspace)(start=0.0, stop=1.0, num=3), "lr": 1e-5, "k": [1, None]}
    assert locate("numpy.linspace") is np.linspace
    np.testing.assert_array_equal(instantiate(cfg)["net"], [0.0, 0.5, 1.0])
    LazyConfig.save(cfg, str(tmp_path / "c.yaml"))
    back = LazyConfig.load(str(tmp_path / "c.yaml"))
    assert back.net._target_ == "numpy.linspace" and back.lr == 1e-5
    np.testing.assert_array_equal(instantiate(back)["net"], [0.0, 0.5, 1.0])


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(model_config("n"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, model_config("n"), output_dir=str(tmp_path), tensorboard=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", os.path.join(REPO, "configs/coco/detrpose_n.py")])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        Trainer(model, model_config("n"), output_dir=str(tmp_path), tensorboard=False,
                device="cpu", n_devices=2)
