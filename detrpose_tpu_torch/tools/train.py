"""Training / evaluation command line of the port.

The counterpart of the repository's ``train.py`` (the JAX package's CLI): a
config file (``configs/{coco,crowdpose}/*.py``) defines the experiment, flags
override it. It runs on the CUDA device, training under bf16 autocast;
``--device cpu`` runs it on the CPU in float32.

  python -m detrpose_tpu_torch.tools.train --config configs/coco/detrpose_l.py \\
      --img-dir /data/coco/train2017 \\
      --ann /data/coco/annotations/person_keypoints_train2017.json \\
      --val-img-dir /data/coco/val2017 \\
      --val-ann /data/coco/annotations/person_keypoints_val2017.json

  python -m detrpose_tpu_torch.tools.train --config configs/coco/detrpose_l.py \\
      --val-img-dir ... --val-ann ... --eval --resume output/detrpose_l/best

Data-parallel training runs one process a rank, each on its own card,
started by torchrun (the reference's launch); ``total_batch_size`` is the
global batch, each rank loading total / accumulation / ranks images a
micro-step, and rank 0 writes the outputs:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m detrpose_tpu_torch.tools.train --config configs/coco/detrpose_l.py ...

With ``--device cpu`` the ranks run on the CPU and talk over gloo.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..configs import build_model, model_config
from ..core import LazyConfig
from ..data.coco import CocoKeypointDataset
from ..data.loader import KeypointLoader, Prefetcher
from ..data.transforms import EvalTransforms, TrainTransforms
from ..parallel.dist import init_distributed
from ..train.trainer import Trainer
from ..utils.device import resolve_device


def val_ground_truth(ds: CocoKeypointDataset, K: int):
    """The evaluator's ground truth of a dataset: image id -> {"anns": ...}."""
    return {
        img_id: {"anns": [
            {"keypoints": np.asarray(a["keypoints"], np.float64).reshape(K, 3),
             "area": a.get("area", a["bbox"][2] * a["bbox"][3]),
             "bbox": a["bbox"], "iscrowd": a.get("iscrowd", 0),
             "num_keypoints": a.get("num_keypoints", 0)}
            for a in ds.anns_by_img.get(img_id, [])
        ]}
        for img_id in ds.ids
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--options", nargs="*", default=[], help="a.b.c=value overrides")
    p.add_argument("--img-dir")
    p.add_argument("--ann")
    p.add_argument("--val-img-dir")
    p.add_argument("--val-ann")
    p.add_argument("--resume", help="a checkpoint of this package's Trainer, or an orbax "
                   "checkpoint directory of the JAX package (weights, EMA and counters; "
                   "a fresh optimizer)")
    p.add_argument("--ckpt-pth", help="reference zoo .pth to load")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--test", action="store_true",
                   help="write results.json (test-dev submission format)")
    p.add_argument("--output-dir")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--epochs", type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; bf16 autocast) or cpu (float32)")
    return p.parse_args(argv)


def main(argv=None) -> Trainer:
    """Run the command line on ``argv``; returns the Trainer (its
    ``history`` holds each epoch's times, ``evaluator`` the last
    evaluation)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rank, world = init_distributed(dev)
    cfg = LazyConfig.load(args.config)
    LazyConfig.apply_overrides(cfg, args.options)
    tp = cfg.training_params
    if args.output_dir:
        tp["output_dir"] = args.output_dir
    if args.batch_size:
        tp["total_batch_size"] = args.batch_size
    if args.epochs:
        tp["epochs"] = args.epochs

    overrides = dict(getattr(cfg, "model_overrides", {}) or {})
    mcfg = model_config(cfg.model_size, num_body_points=cfg.num_body_points, **overrides)
    model = build_model(mcfg, device=dev)
    grad_accum = max(int(tp.get("grad_accum_steps", 1)), 1)

    train_loader = val_loader = None
    val_gts = crowd_index = None
    eval_use_area = True
    K = cfg.num_body_points
    if args.img_dir and args.ann and not (args.eval or args.test):
        tds = CocoKeypointDataset(
            args.img_dir, args.ann, K, train=True,
            transforms=TrainTransforms(
                out_size=tp.get("base_size", 640), num_keypoints=K,
                policy_epochs=tuple(tp.get("policy_epochs", (5, 29, 48))),
                # no shipped reference config crops; when one does, CrowdPose
                # crops in clamp mode (transforms_crowdpose.py:57-66)
                use_crop=tp.get("use_crop", False),
                crop_mode="clamp" if K == 14 else "zero"))
        # with accumulation the loader yields micro-batches of total / accum
        # (reference engine.py:43-60 splits each batch), a rank's share of
        # them (JAX train.py:80-90)
        micro_bs = max(tp.get("total_batch_size", 16) // grad_accum // world, 1)
        train_loader = Prefetcher(KeypointLoader(
            tds, micro_bs, K, train=True,
            base_size=tp.get("base_size", 640),
            base_size_repeat=tp.get("base_size_repeat"),
            multiscale_stop_epoch=tp.get("multiscale_stop_epoch", 48),
            num_queries=mcfg.num_queries,
            # reference: DataLoader(num_workers=4), include/dataset.py:48
            num_workers=tp.get("num_workers", 4),
            process_index=rank, process_count=world))
    if args.val_img_dir and args.val_ann:
        vds = CocoKeypointDataset(
            args.val_img_dir, args.val_ann, K, train=False,
            transforms=EvalTransforms(out_size=tp.get("base_size", 640)))
        val_loader = KeypointLoader(vds, tp.get("eval_batch_size", 32), K, train=False,
                                    with_cdn=False, drop_last=False,
                                    process_index=rank, process_count=world)
        val_gts = val_ground_truth(vds, K)
        crowd_index = vds.crowd_index
        eval_use_area = crowd_index is None  # CrowdPose normalizes by box area

    trainer = Trainer(
        model, mcfg,
        train_loader=train_loader, val_loader=val_loader, val_gts=val_gts,
        eval_use_area=eval_use_area, crowd_index=crowd_index,
        output_dir=tp.get("output_dir", "output"),
        epochs=tp.get("epochs", 52),
        lr=tp.get("lr", 1e-4), backbone_lr=tp.get("backbone_lr", 1e-5),
        weight_decay=tp.get("weight_decay", 1e-4),
        clip_max_norm=tp.get("clip_max_norm", 0.1),
        milestones=tuple(tp.get("milestones", (1000,))),
        warmup_steps=tp.get("warmup_steps", 0),
        grad_accum_steps=grad_accum,
        use_ema=tp.get("use_ema", True),
        ema_decay=tp.get("ema_decay", 0.9999),
        ema_warmups=tp.get("ema_warmups", 2000),
        # criterion losses and weights are config-addressable (the reference
        # instantiates Criterion(losses=..., weight_dict=...) from the config)
        weight_dict=dict(getattr(cfg, "weight_dict", None) or {}) or None,
        losses=tuple(getattr(cfg, "losses", None) or ("vfl", "keypoints")),
        # backbone freeze knobs (reference hgnetv2.py:526-533,566-569; no-ops
        # in shipped configs, include/detrpose_hgnetv2.py:34-35)
        freeze_at=tp.get("freeze_at", -1),
        freeze_stem_only=tp.get("freeze_stem_only", True),
        freeze_backbone=tp.get("freeze_backbone", False),
        # None: uint8 staging of train images under bf16 (see Trainer)
        stage_uint8=tp.get("stage_uint8", None),
        compute_dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        n_devices=world, device=dev,
    )
    try:
        # snapshot the resolved config into the run directory (reference
        # logs the config text to TB and pickles args, trainer.py:130-134)
        if trainer.main:
            LazyConfig.save(dict(cfg), os.path.join(trainer.output_dir, "config.yaml"))
        if args.resume:
            trainer.resume(args.resume)
        if args.ckpt_pth:
            trainer.load_torch_weights(args.ckpt_pth)
        if args.test:
            trainer.test()
        elif args.eval:
            stats = trainer.evaluate()
            if trainer.main:
                print(json.dumps(stats), flush=True)
        else:
            trainer.fit()
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
