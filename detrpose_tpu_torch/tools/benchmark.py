"""Benchmark and model-info tools.

Counterpart of ``detrpose_tpu/tools/benchmark.py`` (``model_info``,
``bench_size``, ``main``), after the reference suite
(tools/benchmark/get_info.py, tools/benchmark/torch_benchmark.py):

* ``model_info``: parameters, and GFLOPs of one forward at (1, 3, res, res)
  counted by ``torch.utils.flop_counter.FlopCounterMode``. That counts the
  convolutions and matrix products only. It does not count MSDA (a custom
  op), elementwise work or norms, which XLA's cost analysis in the JAX
  package does count, so the two numbers differ.
* ``bench_size``: forward + postprocess of random images on the CUDA device,
  timed with CUDA events after a warm-up, with each kernel's launches during
  the timed calls. On the CPU (``device="cpu"``) the host clock times it and
  the result says so.
* ``bench_train_step``: the training step (``parallel/train_step.py``: bf16
  autocast forward, criterion, backward, AdamW, EMA) on a fixed synthetic
  batch with G = 8 poses an image and one CDN batch, timed the same way, with
  the peak device memory.

* ``bench_data``: the reference's latency protocol on real images
  (tools/benchmark/torch_benchmark.py, dataset.py): each image decoded by
  PIL, resized to 639 on its short side (640 at most on its long one) and
  padded to 640 with 114 (``_preprocess_image``), then per batch the copy to
  the device, the forward and the postprocess, each batch's host time up to
  ``torch.cuda.synchronize``; the mean, the mean of the fastest 10% and
  images/s, under JAX's keys. Without an image directory it writes
  synthetic JPEGs of 320-640 x 240-480 px to a temporary directory.

  python -m detrpose_tpu_torch.tools.benchmark --sizes n s m l x --batch 1 32
  python -m detrpose_tpu_torch.tools.benchmark --train --sizes l --batch 8
  python -m detrpose_tpu_torch.tools.benchmark --data [DIR] --sizes l --batch 1 32
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import build_model, model_config
from ..models import postprocess
from ..ops.cuda import KERNELS
from ..parallel.train_step import make_train_step
from ..train.cdn import build_cdn, cdn_to_device
from ..train.optim import make_optimizer
from ..utils.device import resolve_device
from ..utils.measure import cuda_time_ms

SIZES = ("n", "s", "m", "l", "x")


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def launch_counts() -> Dict[str, int]:
    """Each CUDA kernel's launch count so far in this process."""
    return {name: k.launches for name, k in KERNELS.items()}


def model_info(size: str, num_body_points: int = 17, res: int = 640,
               device: torch.device | str = "cuda") -> dict:
    """Parameters and conv + matmul GFLOPs of one (1, 3, res, res) forward."""
    dev = resolve_device(device)
    model = build_model(model_config(size, num_body_points=num_body_points), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    flops = FlopCounterMode(display=False)
    with torch.no_grad(), flops:
        model(torch.zeros(1, 3, res, res, device=dev))
    return {"size": size, "params": n_params, "params_M": round(n_params / 1e6, 2),
            "gflops": round(flops.get_total_flops() / 1e9, 1), "res": res,
            "flops_counted": "conv and matmul (FlopCounterMode); not MSDA, "
                             "elementwise or norms",
            "device": _device_name(dev)}


def bench_size(size: str, batch: int, res: int = 640, bf16: bool = True,
               warmup: int = 10, iters: int = 50, device: torch.device | str = "cuda",
               num_body_points: int = 17) -> dict:
    """Forward + postprocess of ``batch`` random images at ``res`` px: mean
    latency over ``iters`` calls after ``warmup`` calls, and each kernel's
    launches during the timed calls."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = build_model(model_config(size, num_body_points=num_body_points, dtype=dtype),
                        device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 3, res, res)).astype(np.float32))
    x = x.to(dev, dtype)
    ts = torch.full((batch, 2), float(res), device=dev)

    def fwd():
        return postprocess(model(x), ts, num_body_points=num_body_points)

    with torch.no_grad():
        for _ in range(max(1, warmup)):
            fwd()
        before = launch_counts()
        if dev.type == "cuda":
            ms, basis = cuda_time_ms(fwd, iters, warmup=0), "cuda_events"
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fwd()
            ms, basis = (time.perf_counter() - t0) / iters * 1e3, "cpu_host_clock"
        after = launch_counts()
    return {"size": size, "batch": batch, "res": res, "bf16": bf16,
            "latency_ms": round(ms, 3), "images_per_sec": round(batch * 1e3 / ms, 1),
            "basis": basis, "iters": iters, "device": _device_name(dev),
            "launches": {k: after[k] - before[k] for k in after}}


def _preprocess_image(img, res: int = 640):
    """The reference latency protocol's preprocessing (tools/benchmark/
    dataset.py:46-83; JAX ``tools/benchmark.py:107-125``): torchvision's
    ``Resize(size=res-1, max_size=res)`` (the short side to res-1 unless the
    long side would pass res, then the long side to res) by PIL bilinear,
    padded right and bottom to res x res with 114, scaled to [0, 1] ->
    ((res, res, 3) float32, the original (w, h))."""
    from PIL import Image

    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    new_short = res - 1
    new_long = int(new_short * long / short)
    if new_long > res:
        new_short, new_long = int(res * new_short / new_long), res
    nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
    resized = img.resize((nw, nh), Image.BILINEAR)
    canvas = np.full((res, res, 3), 114, np.uint8)
    canvas[:nh, :nw] = np.asarray(resized, np.uint8)
    return canvas.astype(np.float32) / 255.0, (w, h)


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def write_synthetic_jpegs(root: str, n: int, seed: int = 0) -> None:
    """``n`` JPEGs of uniform noise, 320-640 px wide and 240-480 high (JAX
    ``bench_data``'s stand-in for a real directory)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        w, h = int(rng.integers(320, 641)), int(rng.integers(240, 481))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB").save(
            os.path.join(root, f"{i:06d}.jpg"), quality=90)


def bench_data(size: str, img_dir: Optional[str], batch: int = 1, res: int = 640,
               bf16: bool = True, warmup: int = 40, num_images: int = 200,
               num_body_points: int = 17, device: torch.device | str = "cuda") -> dict:
    """Latency over real images with the reference's preprocessing: every
    image of ``img_dir`` (the first ``num_images``; an empty directory is
    refused, and none given means synthetic JPEGs) preprocessed on the host
    once, then ``warmup`` untimed batches and each batch timed on the host
    clock from the copy to the device to ``torch.cuda.synchronize``.
    ``latency_ms`` is the mean a batch, ``fastest_ms`` the mean of the
    fastest 10% (the reference's fastest segment)."""
    from PIL import Image

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_jpegs_") as tmp:
        if img_dir:
            paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                           if f.lower().endswith(IMAGE_EXTS))
            if not paths:
                raise SystemExit(f"--data {img_dir}: no images found (looked for "
                                 f"{IMAGE_EXTS}); refusing to benchmark synthetic data")
        else:
            write_synthetic_jpegs(tmp, num_images)
            paths = sorted(os.path.join(tmp, f) for f in os.listdir(tmp))
        pre = []
        for path in paths[:num_images]:
            with Image.open(path) as im:
                pre.append(_preprocess_image(im.convert("RGB"), res))
    if len(pre) < batch:
        # fewer images than a batch: cycle them, as JAX does
        pre = (pre * -(-batch // len(pre)))[:batch]
    batches = [(np.stack([c[0] for c in pre[i:i + batch]]),
                np.asarray([c[1] for c in pre[i:i + batch]], np.float32))
               for i in range(0, len(pre) - batch + 1, batch)]

    dtype = torch.bfloat16 if bf16 else torch.float32
    model = build_model(model_config(size, num_body_points=num_body_points, dtype=dtype),
                        device=dev)

    def run(x_np, ts_np):
        x = torch.from_numpy(x_np).to(dev).permute(0, 3, 1, 2).to(dtype)
        scores, _, _ = postprocess(model(x), torch.from_numpy(ts_np).to(dev),
                                   num_body_points=num_body_points)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return scores

    times = []
    with torch.no_grad():
        for _ in range(max(1, warmup)):
            run(*batches[0])
        for x_np, ts_np in batches:
            t0 = time.perf_counter()
            run(x_np, ts_np)
            times.append(time.perf_counter() - t0)
    mean_ms = float(np.mean(times)) * 1e3
    fastest_ms = float(np.mean(sorted(times)[:max(1, len(times) // 10)])) * 1e3
    return {"size": size, "batch": batch, "res": res, "mode": "data",
            "images": len(batches) * batch, "img_dir": img_dir,
            "latency_ms": round(mean_ms, 3),
            "basis": ("host_wall_incl_h2d_synchronized" if dev.type == "cuda"
                      else "cpu_host_clock"),
            "per_batch_wall_ms": round(float(np.median(times)) * 1e3, 3),
            "fastest_ms": round(fastest_ms, 3),
            "images_per_sec": round(batch * 1e3 / mean_ms, 1),
            "device": _device_name(dev)}


def synthetic_train_batch(batch: int, res: int, num_body_points: int, num_queries: int,
                          device: torch.device, G: int = 8, seed: int = 0) -> dict:
    """A fixed training batch: ``batch`` random images at ``res`` px, G poses
    an image with keypoints in [0.2, 0.8], all visible, area 0.04, and the CDN
    batch built from them (JAX ``bench_train_step``'s targets)."""
    K = num_body_points
    rng = np.random.default_rng(seed)
    kxy = rng.uniform(0.2, 0.8, (batch, G, K, 2)).astype(np.float32)
    targets = {
        "labels": np.zeros((batch, G), np.int32),
        "boxes": np.concatenate([kxy.mean(2), np.full((batch, G, 2), 0.2, np.float32)], -1),
        "keypoints": np.concatenate(
            [kxy.reshape(batch, G, 2 * K), np.ones((batch, G, K), np.float32)], -1),
        "area": np.full((batch, G), 0.04, np.float32),
        "valid": np.ones((batch, G), bool),
    }
    dn = build_cdn(targets, num_queries, K, (res, res), rng)
    images = rng.uniform(0, 1, (batch, 3, res, res)).astype(np.float32)
    return {"images": torch.from_numpy(images).to(device),
            "targets": {k: torch.from_numpy(v).to(device) for k, v in targets.items()},
            "dn": cdn_to_device(dn, device)}


def bench_train_step(size: str, batch: int = 8, res: int = 640, num_body_points: int = 17,
                     warmup: int = 3, iters: int = 10, grad_accum_steps: int = 1,
                     device: torch.device | str = "cuda", remat: bool = False) -> dict:
    """The full training step (bf16 autocast forward, criterion, backward,
    clip, AdamW, EMA) on a fixed synthetic batch: ms per micro-step and per
    optimiser step, images/s, the peak device memory, and each kernel's
    launches over ``iters`` timed micro-steps after ``warmup`` untimed ones.
    On the CPU (``device="cpu"``) the host clock times it, in float32."""
    dev = resolve_device(device)
    cfg = model_config(size, num_body_points=num_body_points, remat=remat)
    model = build_model(cfg, device=dev)
    opt = make_optimizer(model, grad_accum_steps=grad_accum_steps)
    step = make_train_step(model, opt, num_body_points, device=dev,
                           compute_dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    data = synthetic_train_batch(batch, res, num_body_points, cfg.num_queries, dev)
    for _ in range(max(1, warmup)):
        m = step(data)
    before = launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, basis = cuda_time_ms(lambda: step(data), iters, warmup=0), "cuda_events"
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            m = step(data)
        ms, basis, peak = (time.perf_counter() - t0) / iters * 1e3, "cpu_host_clock", None
    after = launch_counts()
    m = step(data)
    k = opt.grad_accum_steps
    return {"size": size, "batch": batch, "res": res, "mode": "train",
            "grad_accum_steps": k, "remat": remat,
            "step_ms": round(ms, 3), "opt_step_ms": round(k * ms, 3),
            "images_per_sec": round(batch * 1e3 / ms, 1), "peak_mem_bytes": peak,
            "basis": basis, "iters": iters, "device": _device_name(dev),
            "finite": bool(m["finite"]), "loss": round(float(m["loss_total"]), 4),
            "launches": {name: after[name] - before[name] for name in after}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", nargs="+", default=list(SIZES), choices=SIZES)
    p.add_argument("--batch", nargs="+", type=int, default=[1, 32])
    p.add_argument("--res", type=int, default=640)
    p.add_argument("--info-only", action="store_true")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--train", action="store_true",
                   help="time the training step instead of the forward")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--data", nargs="?", const="", default=None, metavar="DIR",
                   help="the real-image leg: the reference's preprocessing over "
                        "DIR's images; with no DIR, synthetic JPEGs")
    args = p.parse_args(argv)
    for size in args.sizes:
        if args.data is not None:
            for b in args.batch:
                print(json.dumps(bench_data(size, args.data or None, b, args.res)),
                      flush=True)
            continue
        if args.train:
            for b in args.batch:
                print(json.dumps(bench_train_step(size, b, args.res, iters=args.iters,
                                                  grad_accum_steps=args.grad_accum,
                                                  remat=args.remat)), flush=True)
            continue
        print(json.dumps(model_info(size, res=args.res)), flush=True)
        if args.info_only:
            continue
        for b in args.batch:
            print(json.dumps(bench_size(size, b, args.res, iters=args.iters)), flush=True)


if __name__ == "__main__":
    main()
