"""The port's visual command line and real-image benchmark against the JAX package.

``draw_poses`` and the skeleton tables bit for bit against JAX's
(``detrpose_tpu/tools/infer.py``); the command line at N on an image, a
folder of images and a 4-frame mp4 with ``--device cpu`` (files written,
frames counted, the printed lines), and with ``--ckpt`` in the reference's
checkpoint layout (EMA preferred); ``_preprocess_image`` bit for bit against
JAX's (``detrpose_tpu/tools/benchmark.py``) on its own battery of sizes;
``bench_data`` at N, batch 1, over 4 synthetic JPEGs, with JAX's keys.
Without ``--device cpu`` both default to the CUDA device and raise without one.
``build_pipeline`` takes ``model_config``'s keys as keyword overrides (the
energy refinement variant serves a frame; a checkpoint of that variant
loads into it), and refuses a key ``ModelConfig`` lacks.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from detrpose_tpu.tools import infer as jax_infer
from detrpose_tpu.tools.benchmark import _preprocess_image as jax_preprocess_image

from detrpose_tpu_torch.tools import infer
from detrpose_tpu_torch.tools.benchmark import _preprocess_image, bench_data

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("K", [17, 14])
def test_draw_poses_matches_jax(K):
    rng = np.random.default_rng(K)
    img = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    kpts = np.concatenate([rng.uniform(-10, 330, (6, K, 2)), rng.uniform(0, 1, (6, K, 1))],
                          -1).astype(np.float32)
    scores = rng.uniform(0, 1, 6).astype(np.float32)
    got = infer.draw_poses(img, kpts, scores, 0.4, K)
    want = jax_infer.draw_poses(img, kpts, scores, 0.4, K)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    assert infer.COCO_SKELETON == jax_infer.COCO_SKELETON
    assert infer.CROWDPOSE_SKELETON == jax_infer.CROWDPOSE_SKELETON


def _jpeg(path, w, h, seed):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)).save(
        path, quality=90)


def test_command_line_image_and_folder(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    for i, (w, h) in enumerate(((320, 240), (200, 300))):
        _jpeg(src / f"{i}.jpg", w, h, i)
    (src / "notes.txt").write_text("not an image")
    infer.main(["--size", "n", "--input", str(src / "0.jpg"), "--output",
                str(tmp_path / "one.jpg"), "--device", "cpu"])
    assert cv2.imread(str(tmp_path / "one.jpg")).shape == (240, 320, 3)
    infer.main(["--size", "n", "--input", str(src), "--output", str(tmp_path / "out"),
                "--device", "cpu", "--thresh", "0.0"])
    assert sorted(os.listdir(tmp_path / "out")) == ["0.jpg", "1.jpg"]
    assert cv2.imread(str(tmp_path / "out" / "1.jpg")).shape == (300, 200, 3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{src / '0.jpg'} -> {tmp_path / 'one.jpg'} (")
    # threshold 0 keeps every one of the 60 detections
    assert lines[1].endswith("0.jpg (60 poses)") and lines[2].endswith("1.jpg (60 poses)")
    with pytest.raises(SystemExit):
        infer.main(["--size", "n", "--input", str(src), "--output",
                    str(tmp_path / "x.jpg"), "--device", "cpu"])


def test_command_line_video(tmp_path):
    inp, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    w = cv2.VideoWriter(inp, cv2.VideoWriter_fourcc(*"mp4v"), 5, (320, 240))
    rng = np.random.default_rng(0)
    for _ in range(4):
        w.write(rng.integers(0, 255, (240, 320, 3), np.uint8))
    w.release()
    r = subprocess.run([sys.executable, "-m", "detrpose_tpu_torch.tools.infer", "--size", "n",
                        "--input", inp, "--output", out, "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("(4 frames)"), r.stdout
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4


def test_checkpoint_prefers_ema(tmp_path):
    a = infer.build_pipeline("n", device="cpu", generator=torch.Generator().manual_seed(1))
    b = infer.build_pipeline("n", device="cpu", generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": a.model.state_dict(), "ema": {"module": b.model.state_dict()}}, path)
    run = infer.build_pipeline("n", ckpt=path, device="cpu")
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k].to(v.dtype)), k


ENERGY = dict(use_energy_refinement=True, grad_energy=True)


def test_build_pipeline_serves_the_energy_variant(tmp_path):
    run = infer.build_pipeline("n", device="cpu", **ENERGY)
    decoder = run.model.transformer.decoder
    assert hasattr(decoder, "energy_layer") and decoder.grad_energy
    assert decoder.energy_steps == 3
    rgb = np.random.default_rng(3).integers(0, 256, (120, 160, 3), np.uint8)
    scores, labels, kpts = run(rgb, (160, 120))
    assert scores.shape == labels.shape == (1, 60) and kpts.shape == (1, 60, 17, 3)
    assert torch.isfinite(scores).all() and torch.isfinite(kpts).all()
    # a checkpoint of the variant loads into the model the overrides built
    src = infer.build_pipeline("n", device="cpu", generator=torch.Generator().manual_seed(4),
                               **ENERGY)
    path = str(tmp_path / "energy.pth")
    torch.save({"model": src.model.state_dict()}, path)
    loaded = infer.build_pipeline("n", ckpt=path, device="cpu", **ENERGY)
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, src.model.state_dict()[k]), k


def test_build_pipeline_refuses_an_unknown_key():
    with pytest.raises(TypeError, match="bogus"):
        infer.build_pipeline("n", device="cpu", bogus=1)


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _jpeg(tmp_path / "a.jpg", 64, 48, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--size", "n", "--input", str(tmp_path / "a.jpg"), "--output",
                    str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_data("n", str(tmp_path), 1, num_images=1, warmup=1)


def test_preprocess_image_matches_jax():
    rng = np.random.default_rng(0)
    for w, h in [(640, 480), (480, 640), (639, 639), (1000, 200), (320, 320), (641, 641),
                 (123, 777), (640, 640), (999, 998), (97, 640)]:
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB")
        got, got_wh = _preprocess_image(img)
        want, want_wh = jax_preprocess_image(img)
        assert got_wh == want_wh == (w, h)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bench_data_on_the_cpu(tmp_path):
    res = bench_data("n", None, 1, num_images=4, warmup=1, device="cpu")
    # the keys of JAX's bench_data (tools/benchmark.py:222-233), and the device
    assert set(res) == {"size", "batch", "res", "mode", "images", "img_dir", "latency_ms",
                        "basis", "per_batch_wall_ms", "fastest_ms", "images_per_sec",
                        "device"}
    assert res["images"] == 4 and res["mode"] == "data" and res["basis"] == "cpu_host_clock"
    assert 0 < res["fastest_ms"] <= res["latency_ms"]
    with pytest.raises(SystemExit, match="no images"):
        bench_data("n", str(tmp_path), 1, device="cpu")
