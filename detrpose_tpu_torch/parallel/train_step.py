"""The training step: forward (train), criterion, backward, gradient
accumulation, clip, AdamW, EMA, and the skip on a non-finite loss.

Counterpart of ``detrpose_tpu/parallel/train_step.py::make_train_step``,
which replaces the reference's engine.train_one_epoch inner loop
(src/solver/engine.py:37-97). The forward runs under ``torch.autocast`` in
``compute_dtype`` (bf16 by default: float32 master weights, no GradScaler, as
JAX's bf16 compute); the criterion runs in float32 outside it.

A non-finite loss skips the whole update (JAX train_step.py:103-138): the
backward does not run, so the parameters, the AdamW state, the accumulated
gradients and the EMA keep their values, the BatchNorm statistics the forward
moved are put back, and the step counter still advances. With accumulation a
skipped micro-batch does not count towards the k (JAX's ``mini_step``
reverts); the EMA advances on optimiser steps only.

Each phase runs inside a profiler range named in ``PHASES`` (forward,
criterion, backward, update), so a trace splits a step's host time by phase.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..models.layers import BatchNorm
from ..train.criterion import criterion as criterion_fn
from ..train.optim import EMA, TrainOptimizer
from ..utils.device import resolve_device

PHASES = ("train_step.forward", "train_step.criterion", "train_step.backward",
          "train_step.update")


class TrainStep:
    """``step(batch) -> metrics``. ``batch``: "images" (B, 3, H, W) in [0, 1],
    "targets" {labels, keypoints, area, valid, ...} as tensors, and optionally
    "dn", the output of ``train/cdn.py::cdn_to_device``, all on the model's
    device. ``metrics``: "loss_total" and every weighted loss term (0-d
    tensors), "finite" (bool) and "step" (int)."""

    def __init__(self, model: nn.Module, optimizer: TrainOptimizer, num_body_points: int,
                 num_classes: int = 2, weight_dict: Optional[Dict[str, float]] = None,
                 matcher_backend: str = "auction", ema_decay: float = 0.9999,
                 ema_warmups: int = 2000, use_ema: bool = True,
                 losses: Sequence[str] = ("vfl", "keypoints"),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.model = model.train()
        self.optimizer = optimizer
        self.num_body_points, self.num_classes = num_body_points, num_classes
        self.weight_dict, self.matcher_backend = weight_dict, matcher_backend
        self.losses = tuple(losses)
        self.compute_dtype = compute_dtype
        self.ema = EMA(model, ema_decay, ema_warmups) if use_ema else None
        self.step = 0          # calls, skipped ones included
        self.micro = 0         # finite micro-batches since the last optimiser step
        optimizer.zero_grad()

    def _bn_stats(self):
        return [t for m in self.model.modules() if isinstance(m, BatchNorm) and m.training
                for t in (m.running_mean, m.running_var)]

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        images = batch["images"]
        dn = batch.get("dn")
        targets = dict(batch["targets"])
        if dn is not None:
            targets["dn_match"] = dn["dn_match"]
        stats = self._bn_stats()
        saved = [t.clone() for t in stats]
        amp = self.compute_dtype not in (None, torch.float32)
        forward, crit, backward, update = (torch.profiler.record_function(n) for n in PHASES)
        with forward, torch.autocast(images.device.type, dtype=self.compute_dtype,
                                     enabled=amp):
            out = self.model(images, dn)
        with crit:
            terms = criterion_fn(out, targets, self.num_body_points, self.num_classes,
                                 weight_dict=self.weight_dict,
                                 matcher_backend=self.matcher_backend, losses=self.losses)
            total = torch.stack([v.float() for v in terms.values()]).sum()
            finite = bool(torch.isfinite(total))
        self.step += 1
        if finite:
            with backward:
                total.backward()
            self.micro += 1
            if self.micro == self.optimizer.grad_accum_steps:
                with update:
                    self.optimizer.step()
                    self.micro = 0
                    if self.ema is not None:
                        self.ema.update(self.model)
        else:
            with torch.no_grad():
                torch._foreach_copy_(stats, saved)
        return {"loss_total": total.detach(), "finite": finite, "step": self.step,
                **{k: v.detach() for k, v in terms.items()}}


def make_train_step(model: nn.Module, optimizer: TrainOptimizer, num_body_points: int,
                    device: torch.device | str = "cuda", **kwargs) -> TrainStep:
    """The training step of ``model`` (put in training mode) with
    ``optimizer`` from ``train/optim.py::make_optimizer``, whose
    ``grad_accum_steps`` sets the accumulation. The model must lie on
    ``device``, the CUDA device unless the caller asks for the CPU. Keywords
    as ``TrainStep``."""
    dev = resolve_device(device)
    where = {p.device.type for p in model.parameters()}
    if where != {dev.type}:
        raise ValueError(f"make_train_step: the model lies on {sorted(where)}, "
                         f"not on {dev}; move it or pass device=")
    return TrainStep(model, optimizer, num_body_points, **kwargs)
