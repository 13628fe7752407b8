"""Trainer: the training and evaluation lifecycle, on one device or one
rank of a data-parallel process group.

Counterpart of ``detrpose_tpu/train/trainer.py``. Reference semantics:
src/solver/trainer.py (fit epoch loop :172-309, eval :311-341, resume
:343-379) and src/solver/engine.py (train_one_epoch :15-117, evaluate
:120-176). On the port:
  * one device a process (the CUDA device unless the caller asks for the
    CPU); across ranks, one process a rank under ``torch.distributed``
    (``parallel/dist.py``), the model in ``DistributedDataParallel``, where
    JAX shards the global batch over a mesh (``n_devices`` is the world
    size). Each rank's loaders hold its shard; a CDN block is built on every
    rank with the global batch's group count; evaluation merges the ranks'
    detections and summarises on every rank; log.txt, TensorBoard, the eval
    dump, results.json and the checkpoints are written by rank 0 alone;
  * the step is ``parallel/train_step.py::TrainStep``: float32 master
    weights, the forward under autocast in ``compute_dtype`` (bf16 by
    default, as JAX's bf16 models), the optimiser of
    ``train/optim.py::make_optimizer``, EMA over the weights and the BN
    statistics;
  * checkpoints through ``torch.save`` (``utils/checkpoint.py``);
  * a non-finite loss stops training (engine.py:68-71) at the step that
    gave it; the step itself has already skipped its update.

The eval forward runs on a copy of the model in eval mode that takes the EMA
weights (with their own BN statistics) or the live ones, under the same
autocast. Each epoch's host times (seconds, the time spent waiting on the
loader, the images trained and evaluated) are kept in ``history``.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.evaluator import KeypointEvaluator
from ..models.postprocess import postprocess
from ..parallel.dist import barrier, gather_lists, is_main_process, merge_detections, world
from ..parallel.train_step import make_train_step
from ..train.cdn import batch_cdn, cdn_to_device
from ..train.optim import make_optimizer, multistep_schedule, resolve_backbone_freeze
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from ..utils.meters import BestMetricHolder, MetricLogger


class Trainer:
    def __init__(
        self,
        model,
        model_cfg,
        train_loader=None,
        val_loader=None,
        val_gts: Optional[Dict] = None,
        output_dir: str = "output",
        epochs: int = 52,
        lr: float = 1e-4,
        backbone_lr: float = 1e-5,
        weight_decay: float = 1e-4,
        clip_max_norm: float = 0.1,
        milestones=(1000,),
        gamma: float = 0.1,
        warmup_steps: int = 0,
        grad_accum_steps: int = 1,
        use_ema: bool = True,
        ema_decay: float = 0.9999,
        ema_warmups: int = 2000,
        matcher_backend: str = "auction",
        weight_dict=None,
        losses=("vfl", "keypoints"),
        save_interval: int = 1,
        n_devices: Optional[int] = None,
        log_fn=print,
        tensorboard: bool = True,
        eval_use_area: bool = True,
        crowd_index: Optional[Dict] = None,
        freeze_at: int = -1,
        freeze_stem_only: bool = True,
        freeze_backbone: bool = False,
        stage_uint8: Optional[bool] = None,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        device: torch.device | str = "cuda",
    ):
        if n_devices is not None and n_devices != world():
            raise RuntimeError(
                f"n_devices={n_devices} needs a process group of {n_devices} ranks, one "
                f"process a rank (this process sees {world()}): launch with `python -m "
                f"torch.distributed.run --nproc_per_node {n_devices} ...`, whose ranks "
                f"join it in parallel/dist.py::init_distributed")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model_cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_gts = val_gts
        self.eval_use_area = eval_use_area
        self.crowd_index = crowd_index
        self.output_dir = output_dir
        self.epochs = epochs
        self.use_ema = use_ema
        self.save_interval = save_interval
        self.main = is_main_process()
        # the reference prints on the main process only (dist_utils.py:21-35)
        self.log = log_fn if self.main else (lambda *a, **k: None)
        self.compute_dtype = compute_dtype
        os.makedirs(output_dir, exist_ok=True)

        # Milestones are epochs in the config; the optimiser counts its own
        # steps (with accumulation, one per grad_accum_steps micro-batches).
        # ResNet parity: the reference freezes conv1/bn1/layer1
        # (resnet.py:64-66); an explicit freeze_at still wins.
        freeze_at, freeze_stem_only = resolve_backbone_freeze(
            getattr(model_cfg, "backbone_name", ""), freeze_at,
            freeze_stem_only, freeze_backbone)
        self.grad_accum_steps = max(int(grad_accum_steps), 1)
        micro_per_epoch = len(train_loader) if train_loader is not None else 1
        opt_steps_per_epoch = max(micro_per_epoch // self.grad_accum_steps, 1)
        self._opt_milestones = [m * opt_steps_per_epoch for m in milestones]
        self._lr_args = (lr, backbone_lr, gamma, warmup_steps)
        self.optimizer = make_optimizer(
            model, lr, backbone_lr, weight_decay=weight_decay,
            clip_max_norm=clip_max_norm, milestones=self._opt_milestones,
            gamma=gamma, warmup_steps=warmup_steps,
            grad_accum_steps=self.grad_accum_steps, freeze_at=freeze_at,
            freeze_stem_only=freeze_stem_only, freeze_backbone=freeze_backbone)
        self.step = make_train_step(
            model, self.optimizer, model_cfg.num_body_points, device=self.device,
            num_classes=model_cfg.num_classes, weight_dict=weight_dict,
            losses=tuple(losses), matcher_backend=matcher_backend,
            ema_decay=ema_decay, ema_warmups=ema_warmups, use_ema=use_ema,
            compute_dtype=compute_dtype)
        self._eval_model = copy.deepcopy(model).eval()
        # bf16 compute: ship train images as uint8 (pixels * 255) and
        # dequantize on the device, 4x fewer host-to-device bytes than
        # float32; up to ~2 bits of input precision on dark pixels, below the
        # bf16 input's own. Eval always stages float: the AP protocol is held
        # on exact float inputs (JAX trainer.py:146-159).
        self._img_u8 = (compute_dtype == torch.bfloat16 if stage_uint8 is None
                        else bool(stage_uint8))
        self._seen_programs: set = set()
        self.start_epoch = 0
        self.best_ap = -1.0
        # dual best tracking (reference src/misc/metrics.py:12-84)
        self.best_holder = BestMetricHolder(use_ema=use_ema)
        self.evaluator: Optional[KeypointEvaluator] = None   # the last evaluate()'s
        self.history: List[Dict[str, float]] = []
        # TensorBoard scalars (reference: trainer.py:130-134, engine.py:99-107)
        # when the tensorboard package is there, as JAX's optional writer
        self._tb = None
        if tensorboard and self.main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))

    def close(self):
        """Close the TensorBoard writer."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def _tb_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        if self._tb is None:
            return
        for k, v in scalars.items():
            self._tb.add_scalar(prefix + k, float(v), step)
        self._tb.flush()

    # ----------------------------------------------------------------- data
    def _stage_images(self, images, for_eval: bool = False) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1] on the host -> (B, 3, H, W) float32 on
        the device, through uint8 for training where staging asks for it."""
        img = np.asarray(images, np.float32)
        if self._img_u8 and not for_eval:
            u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
            x = torch.from_numpy(u8).to(self.device).float() / 255.0
        else:
            x = torch.from_numpy(img).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous()

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {"images": self._stage_images(batch["images"]),
               "targets": {k: torch.from_numpy(np.asarray(v)).to(self.device)
                           for k, v in batch["targets"].items()}}
        dn = batch_cdn(batch, self.device)
        if dn is not None:
            out["dn"] = cdn_to_device(dn, self.device)
        return out

    # ----------------------------------------------------------------- train
    def train_one_epoch(self, epoch: int, print_freq: int = 50) -> Dict[str, float]:
        """One epoch of training steps. Returns the mean of every metric over
        the steps that carried it (batches without valid GT have no CDN
        terms), ``step_ms`` (host time a step over the steps whose input
        shape was seen before: the first step of a shape also pays the
        allocator's growth and cuDNN's choice of algorithms), their count,
        the shapes seen and the epoch's seconds."""
        self.train_loader.set_epoch(epoch)
        logger = MetricLogger()
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        steady_s, steady_n, wait_s, n_img = 0.0, 0, 0.0, 0
        t0 = t_end = time.perf_counter()
        for batch in logger.log_every(self.train_loader, print_freq,
                                      header=f"Epoch: [{epoch}]",
                                      total=len(self.train_loader), log_fn=self.log):
            t_got = time.perf_counter()
            wait_s += t_got - t_end
            db = self._device_batch(batch)
            program = (tuple(db["images"].shape), "dn" in db)
            fresh = program not in self._seen_programs
            self._seen_programs.add(program)
            metrics = self.step(db)
            keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
            values = torch.stack([metrics[k].float() for k in keys]).tolist()
            keys.append("finite")
            values.append(float(metrics["finite"]))
            for k, v in zip(keys, values):
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1
            total = values[keys.index("loss_total")]
            if not metrics["finite"]:
                raise RuntimeError(f"Loss is {total}, stopping training (engine.py:68-71)")
            logger.update(loss=total)
            n_img += db["images"].shape[0]
            t_end = time.perf_counter()
            if not fresh:
                steady_s += t_end - t_got
                steady_n += 1
        epoch_s = time.perf_counter() - t0
        out = {k: sums[k] / counts[k] for k in sums}
        if steady_n:
            out["step_ms"] = steady_s / steady_n * 1000.0
        out["steady_steps"] = float(steady_n)
        out["compile_programs"] = float(len(self._seen_programs))
        out["epoch_s"] = epoch_s
        self.history.append({"epoch": epoch, "epoch_s": epoch_s, "data_wait_s": wait_s,
                             "train_images": n_img})
        return out

    # ------------------------------------------------------------------ eval
    def _eval_weights(self, use_ema: bool) -> torch.nn.Module:
        """The eval copy with the EMA weights and their own BN statistics
        (reference ModelEMA averages the whole state_dict, ema.py:55-67) or
        the live ones."""
        ema = self.step.ema
        sd = ema.state_dict() if (use_ema and ema is not None) else self.model.state_dict()
        self._eval_model.load_state_dict(sd, strict=True)
        return self._eval_model

    @torch.no_grad()
    def _detections(self, use_ema: bool):
        """Yield (image ids, scores (B, 60), keypoints (B, 60, K, 3) in
        original pixels) over val_loader, as float32 numpy."""
        model = self._eval_weights(use_ema)
        amp = self.compute_dtype not in (None, torch.float32)
        for batch in self.val_loader:
            x = self._stage_images(batch["images"], for_eval=True)
            sizes = torch.from_numpy(np.asarray(batch["orig_sizes"], np.float32)).to(self.device)
            with torch.autocast(self.device.type, dtype=self.compute_dtype, enabled=amp):
                out = model(x)
            scores, _, kpts = postprocess({k: v.float() for k, v in out.items()}, sizes,
                                          num_body_points=self.cfg.num_body_points)
            yield (batch["image_ids"], scores.cpu().numpy(), kpts.cpu().numpy())

    def evaluate(self, use_ema: Optional[bool] = None) -> Dict[str, float]:
        """AP/AR of the EMA weights (or, with ``use_ema=False``, the live
        ones) on val_loader. The evaluator, its detections included, stays
        in ``self.evaluator``."""
        if self.val_loader is None or self.val_gts is None:
            return {}
        use_ema = self.use_ema if use_ema is None else use_ema
        ev = KeypointEvaluator(self.val_gts, self.cfg.num_body_points,
                               use_area=self.eval_use_area,
                               crowd_index=self.crowd_index)
        t0 = time.perf_counter()
        n_img = 0
        for ids, scores, kpts in self._detections(use_ema):
            for b, img_id in enumerate(ids):
                ev.update(int(img_id), scores[b], kpts[b])
            n_img += len(ids)
        t_forward = time.perf_counter() - t0
        # every rank merges the ranks' detections and summarises (reference
        # coco_eval.synchronize_between_processes, :93-105); the shards are
        # wrap-padded to one length, an image evaluated twice counts once
        ev.dets = merge_detections(ev.dets)
        ev.accumulate()
        stats = ev.summarize()
        self.evaluator = ev
        if self.history:
            rec = self.history[-1]
            rec["eval_s"] = rec.get("eval_s", 0.0) + time.perf_counter() - t0
            rec["eval_forward_s"] = rec.get("eval_forward_s", 0.0) + t_forward
            rec["eval_images"] = rec.get("eval_images", 0) + n_img
        self.log("eval: " + json.dumps({k: round(v, 4) for k, v in stats.items()}))
        # per-epoch eval dump (reference trainer.py:296-304 saves the
        # COCOeval state as eval/latest.pth): precision/recall and stats
        if self.main:
            eval_dir = os.path.join(self.output_dir, "eval")
            os.makedirs(eval_dir, exist_ok=True)
            np.savez(os.path.join(eval_dir, "latest.npz"), precision=ev.precision,
                     recall=ev.recall, **{k: np.float64(v) for k, v in stats.items()})
        return stats

    # ------------------------------------------------------------------ test
    def test(self, out_path: Optional[str] = None, use_ema: Optional[bool] = None,
             score_thresh: float = 0.0) -> str:
        """Run inference over val_loader and write a COCO results.json
        (test-dev submission format; reference: trainer.py:324-341)."""
        if self.val_loader is None:
            raise ValueError("Trainer.test needs a val_loader")
        use_ema = self.use_ema if use_ema is None else use_ema
        results = []
        for ids, scores, kpts in self._detections(use_ema):
            for b, img_id in enumerate(ids):
                for s, k in zip(scores[b], kpts[b]):
                    if s < score_thresh:
                        continue
                    results.append({
                        "image_id": int(img_id),
                        "category_id": 1,
                        "keypoints": [round(float(v), 2) for v in k.reshape(-1)],
                        "score": float(s),
                    })
        # every rank's detections, an image evaluated on two ranks once;
        # rank 0 writes (reference save_on_master, dist_utils.py:38)
        results = gather_lists(results, dedup_key=lambda r: r["image_id"])
        out_path = out_path or os.path.join(self.output_dir, "results.json")
        if self.main:
            with open(out_path, "w") as f:
                json.dump(results, f)
        self.log(f"wrote {len(results)} detections to {out_path}")
        return out_path

    # ------------------------------------------------------------------- fit
    def _save(self, name: str, epoch: int):
        if self.main:
            save_checkpoint(os.path.join(self.output_dir, name), self.step, epoch)

    def fit(self) -> float:
        log_path = os.path.join(self.output_dir, "log.txt")
        base_lr, backbone_lr, gamma, warmup_steps = self._lr_args
        for epoch in range(self.start_epoch, self.epochs):
            train_stats = self.train_one_epoch(epoch)
            # current lrs per group (reference logs them to TB,
            # trainer.py:252-256), as JAX computes them: a function of the
            # training step's calls over the accumulation
            opt_step = self.step.step // self.grad_accum_steps
            train_stats["lr"] = multistep_schedule(
                base_lr, self._opt_milestones, gamma, warmup_steps)(opt_step)
            train_stats["lr_backbone"] = multistep_schedule(
                backbone_lr, self._opt_milestones, gamma, warmup_steps)(opt_step)
            # the EMA weights (the reference's per-epoch eval module,
            # trainer.py:240-250) and, with EMA on, the live ones too, so both
            # best streams are tracked (metrics.py:47-84)
            stats = self.evaluate()
            ap = stats.get("AP", -1.0)
            stats_reg: Dict[str, float] = {}
            if self.use_ema and self.step.ema is not None and self.val_loader is not None:
                stats_reg = self.evaluate(use_ema=False)
            ap_reg = stats_reg.get("AP", -1.0)

            new_best_ema = self.best_holder.update_stream(ap, epoch, is_ema=True)
            new_best_reg = (self.best_holder.update_stream(ap_reg, epoch, is_ema=False)
                            if stats_reg else False)
            self._tb_scalars(epoch, train_stats, "train/")
            self._tb_scalars(epoch, stats, "eval/")
            if stats_reg:
                self._tb_scalars(epoch, stats_reg, "eval_regular/")
            if epoch % self.save_interval == 0 or ap > self.best_ap:
                self._save("checkpoint", epoch)
            if ap > self.best_ap:
                self._save("best", epoch)
            # dual best checkpoints (reference checkpoint_best_regular.pth,
            # trainer.py:268-280, extended with the EMA stream)
            if new_best_ema and self.use_ema:
                self._save("best_ema", epoch)
            if new_best_reg:
                self._save("best_regular", epoch)
            if self.main:
                with open(log_path, "a") as f:
                    f.write(json.dumps({
                        "epoch": epoch,
                        **{f"train_{k}": v for k, v in train_stats.items()},
                        **stats,
                        **{f"regular_{k}": v for k, v in stats_reg.items()},
                        **self.best_holder.summary(),
                    }) + "\n")
            if ap > self.best_ap:
                self.best_ap = ap
        return self.best_ap

    # ---------------------------------------------------------------- resume
    def resume(self, path: str):
        """Restore the training state from a checkpoint of this Trainer, or
        from the JAX package's orbax directory (converted in memory: the
        weights, the EMA and the counters, with a fresh optimiser); the next
        epoch follows the one it was saved after."""
        barrier()   # a checkpoint rank 0 is writing is read once it is whole
        epoch = restore_checkpoint(path, self.step)
        self.start_epoch = epoch + 1
        self.log(f"resumed from {path} at epoch {epoch}")

    def load_torch_weights(self, pth_path: str, prefer_ema: bool = True):
        """Load a reference zoo .pth (the EMA weights when it has them) into
        the model and the EMA: the path to COCO AP parity is converting a
        reference checkpoint, then ``evaluate()``."""
        from ..utils.convert import drop_derived, load_torch_checkpoint

        sd = drop_derived(load_torch_checkpoint(pth_path, prefer_ema=prefer_ema))
        self.model.load_state_dict(sd, strict=True)
        ema = self.step.ema
        if ema is not None:
            with torch.no_grad():
                cur = self.model.state_dict()
                for store in (ema.params, ema.buffers):
                    for k, v in store.items():
                        v.copy_(cur[k])
        self.log(f"loaded torch weights from {pth_path}")
