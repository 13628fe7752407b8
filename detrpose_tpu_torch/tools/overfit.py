"""Evidence that the training stack learns: DETRPose-N trained on a small
drawn synthetic set, then scored by the AP evaluator.

Counterpart of ``tools_local_overfit.py``, with its recipe: N at 160 px on
``data/synthetic.py::make_tiny_coco(draw=True, structured=True)`` (128
images of 2 people), batch 16, 3000 steps, no augmentation (``aug`` as the
optional fourth argument: the reference-style policy), a constant learning
rate cut x0.1 at 85% of the steps, 2 staged epochs: the loader's batches of
two shuffles, each with its own CDN noise, put on the device once and
cycled. It runs through the port's loader, CDN, matcher, criterion, AdamW,
EMA, postprocess and evaluator, and reports

  * the loss every 250 steps (and after the first),
  * train AP of the live weights and of the EMA,
  * held-out AP on 64 fresh images (seed 123), both again,
  * ``VERDICT: LEARNS`` when the better train AP passes 0.3, else ``WEAK``.

The forward runs under bf16 autocast on the CUDA device (float32 master
weights), in float32 on the CPU. The weights are drawn from ``--seed`` (0),
or taken from ``--init``: a ``.pth`` or the JAX package's orbax directory
(its live weights), e.g. the JAX recipe's own initial state converted, so
that both packages train from the same weights.

  python -m detrpose_tpu_torch.tools.overfit [steps] [n_images] [stage_epochs] [aug]
      [--seed S | --init CKPT]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import build_model, model_config
from ..data.coco import CocoKeypointDataset
from ..data.evaluator import KeypointEvaluator
from ..data.loader import KeypointLoader
from ..data.synthetic import make_tiny_coco
from ..data.transforms import EvalTransforms, TrainTransforms
from ..models import postprocess
from ..parallel.train_step import make_train_step
from ..train.cdn import batch_cdn, cdn_to_device
from ..train.optim import make_optimizer
from ..utils.convert import drop_derived, load_torch_checkpoint
from ..utils.device import resolve_device

K = 17


def ground_truth(ds: CocoKeypointDataset) -> Dict[int, dict]:
    """The evaluator's ground truth of a dataset: its annotations a image."""
    return {i: {"anns": [{"keypoints": np.asarray(a["keypoints"], np.float64).reshape(K, 3),
                          "area": a["area"], "bbox": a["bbox"], "iscrowd": 0,
                          "num_keypoints": K}
                         for a in ds.anns_by_img.get(i, [])]}
            for i in ds.ids}


def device_batch(raw: Dict, dev: torch.device) -> Dict:
    """A loader batch on the device: images (B, 3, H, W) float32, targets, and
    its CDN block."""
    out = {"images": torch.from_numpy(np.asarray(raw["images"], np.float32)).to(dev)
           .permute(0, 3, 1, 2).contiguous(),
           "targets": {k: torch.from_numpy(np.asarray(v)).to(dev)
                       for k, v in raw["targets"].items()}}
    dn = batch_cdn(raw, dev)
    if dn is not None:
        out["dn"] = cdn_to_device(dn, dev)
    return out


@torch.no_grad()
def evaluate(model: torch.nn.Module, loader: KeypointLoader, gts: Dict[int, dict],
             compute_dtype: Optional[torch.dtype], dev: torch.device) -> Dict[str, float]:
    """AP/AR of ``model`` (in eval mode) over ``loader``."""
    ev = KeypointEvaluator(gts, K)
    amp = compute_dtype not in (None, torch.float32)
    for b in loader:
        x = torch.from_numpy(np.asarray(b["images"], np.float32)).to(dev).permute(0, 3, 1, 2)
        sizes = torch.from_numpy(np.asarray(b["orig_sizes"], np.float32)).to(dev)
        with torch.autocast(dev.type, dtype=compute_dtype, enabled=amp):
            out = model(x)
        scores, _, kpts = postprocess({k: v.float() for k, v in out.items()}, sizes,
                                      num_body_points=K)
        scores, kpts = scores.cpu().numpy(), kpts.cpu().numpy()
        for j, img_id in enumerate(b["image_ids"]):
            ev.update(int(img_id), scores[j], kpts[j])
    ev.accumulate()
    return ev.summarize()


def overfit(steps: int = 3000, n_images: int = 128, stage_epochs: int = 2, aug: bool = False,
            root: Optional[str] = None, batch: int = 16, res: int = 160,
            sample_every: int = 250, holdout: int = 64, seed: int = 0,
            init: Optional[str] = None, device: torch.device | str = "cuda",
            log: Callable[[str], None] = print) -> Dict:
    """Run the recipe; returns the loss curve, the APs, the verdict and the
    host times (set-up, training, evaluation)."""
    dev = resolve_device(device)
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix="overfit_"))
        return _overfit(steps, n_images, stage_epochs, aug, root, batch, res, sample_every,
                        holdout, initial_model(seed, init, dev), dev, compute_dtype, log)


def initial_model(seed: int, init: Optional[str], dev: torch.device) -> torch.nn.Module:
    """N drawn from ``seed``, or with the live weights of the checkpoint
    ``init``."""
    model = build_model(model_config("n"), device=dev,
                        generator=torch.Generator().manual_seed(seed))
    if init is not None:
        model.load_state_dict(drop_derived(load_torch_checkpoint(init, prefer_ema=False)),
                              strict=True)
    return model


def _overfit(steps, n_images, stage_epochs, aug, root, batch, res, sample_every, holdout,
             model, dev, compute_dtype, log):
    t0 = time.perf_counter()
    decay_at = max(1, int(steps * 0.85))
    stage_epochs = max(1, stage_epochs)
    img_dir, ann = make_tiny_coco(os.path.join(root, "train"), n_images=n_images, w=res,
                                  h=res, people=2, draw=True, structured=True)
    cfg = model_config("n")
    if aug:
        # mosaic in the first half of the staged window, zoom-out, flip and
        # jitter throughout
        tf = TrainTransforms(out_size=res, num_keypoints=K,
                             policy_epochs=(0, max(1, stage_epochs // 2), stage_epochs))
    else:
        tf = EvalTransforms(out_size=res)
    ds = CocoKeypointDataset(img_dir, ann, K, train=True, transforms=tf)
    loader = KeypointLoader(ds, batch_size=batch, num_keypoints=K, train=True, base_size=res,
                            num_queries=cfg.num_queries, seed=0)
    batches: List[Dict] = []
    for e in range(stage_epochs):
        loader.set_epoch(e)
        batches += [device_batch(raw, dev) for raw in loader]
    log(f"{n_images} images x {stage_epochs} staged epochs "
        f"({'augmented' if aug else 'unaugmented'}) = {len(batches)} distinct batches of "
        f"{batch}")

    step = make_train_step(model, make_optimizer(model, milestones=(decay_at,)), K,
                           device=dev, num_classes=cfg.num_classes,
                           compute_dtype=compute_dtype)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = []
    for i in range(steps):
        metrics = step(batches[i % len(batches)])
        if (i + 1) % sample_every == 0 or i == 0:
            samples.append((i + 1, metrics["loss_total"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    curve = [(s, float(v)) for s, v in samples]
    log(f"train: {steps} steps in {train_s:.1f} s ({train_s / max(steps, 1) * 1e3:.1f} "
        f"ms/step)")
    log("loss curve: " + json.dumps([[s, round(v, 4)] for s, v in curve]))

    t0 = time.perf_counter()
    vds = CocoKeypointDataset(img_dir, ann, K, train=False,
                              transforms=EvalTransforms(out_size=res))
    vloader = KeypointLoader(vds, batch_size=batch, num_keypoints=K, train=False,
                             with_cdn=False, drop_last=False)
    h_dir, h_ann = make_tiny_coco(os.path.join(root, "holdout"), n_images=holdout, w=res,
                                  h=res, people=2, seed=123, draw=True, structured=True)
    hds = CocoKeypointDataset(h_dir, h_ann, K, train=False,
                              transforms=EvalTransforms(out_size=res))
    hloader = KeypointLoader(hds, batch_size=8, num_keypoints=K, train=False,
                             with_cdn=False, drop_last=False)
    eval_model = copy.deepcopy(model).eval()
    streams = {"regular": model.state_dict()}
    if step.ema is not None:
        streams["ema"] = step.ema.state_dict()
    stats = {}
    for name, sd in streams.items():
        eval_model.load_state_dict(sd, strict=True)
        stats[name] = evaluate(eval_model, vloader, ground_truth(vds), compute_dtype, dev)
        stats[f"held-out, {name}"] = evaluate(eval_model, hloader, ground_truth(hds),
                                              compute_dtype, dev)
        log(f"AP ({name}): " + json.dumps({k: round(v, 4) for k, v in stats[name].items()}))
        log(f"AP (held-out, {name}): " + json.dumps(
            {k: round(v, 4) for k, v in stats[f"held-out, {name}"].items()}))
    eval_s = time.perf_counter() - t0
    best = "ema" if "ema" in stats and stats["ema"]["AP"] > stats["regular"]["AP"] else "regular"
    train_ap, held_ap = stats[best]["AP"], stats[f"held-out, {best}"]["AP"]
    verdict = "LEARNS" if train_ap > 0.3 else "WEAK"
    log(f"VERDICT: {verdict} (train AP={train_ap:.3f}, held-out AP={held_ap:.3f}, "
        f"loss {curve[0][1]:.1f} -> {curve[-1][1]:.1f})")
    return {"steps": steps, "decay_at": decay_at, "batches": len(batches), "curve": curve,
            "stats": stats, "best": best, "verdict": verdict,
            "eval_batches": len(streams) * (len(vloader) + len(hloader)), "setup_s": setup_s,
            "train_s": train_s, "step_ms": train_s / max(steps, 1) * 1e3, "eval_s": eval_s,
            "finite": all(np.isfinite(v) for _, v in curve)}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("steps", nargs="?", type=int, default=3000)
    p.add_argument("n_images", nargs="?", type=int, default=128)
    p.add_argument("stage_epochs", nargs="?", type=int, default=2)
    p.add_argument("aug", nargs="?", default="", choices=["", "aug"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--root", help="where the sets are written (default: a temporary "
                   "directory)")
    w = p.add_mutually_exclusive_group()
    w.add_argument("--seed", type=int, default=0, help="the weights' seed (default 0)")
    w.add_argument("--init", help="start from this checkpoint's live weights: a .pth or "
                   "the JAX package's orbax directory")
    args = p.parse_args(argv)
    r = overfit(args.steps, args.n_images, args.stage_epochs, args.aug == "aug",
                root=args.root, seed=args.seed, init=args.init, device=args.device)
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
