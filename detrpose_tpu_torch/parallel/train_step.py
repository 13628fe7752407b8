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

Across data-parallel ranks (a process group; ``parallel/mesh.py``) the model
runs inside ``DistributedDataParallel``, and the step keeps JAX's semantics
over the global batch. The criterion's normalisers and the BatchNorm
statistics are global, so each rank's loss is its share of the global loss;
it is scaled by the world size before the backward, so DDP's gradient
average is the gradient of the global loss. One all-reduce after the
criterion sums every rank's loss terms (the logged metrics are the global
batch's, as the reference's ``reduce_dict``) and their finite flags: every
rank skips together, or a rank that skipped the backward would leave the
others waiting in DDP's gradient all-reduce. Micro-batches before the last
of an accumulation run under ``no_sync``, so the gradients are all-reduced
once an optimiser step. The clip, AdamW and the EMA run on every rank on the
same reduced gradients.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..models.layers import BatchNorm
from ..train.criterion import criterion as criterion_fn
from ..train.optim import EMA, TrainOptimizer
from ..utils.device import resolve_device
from ..utils.measure import span
from .dist import all_reduce_counts, world
from .mesh import data_parallel

PHASES = ("train_step.forward", "train_step.criterion", "train_step.backward",
          "train_step.update")


class TrainStep:
    """``step(batch) -> metrics``. ``batch``: "images" (B, 3, H, W) in [0, 1],
    "targets" {labels, keypoints, area, valid, ...} as tensors, and optionally
    "dn", the output of ``train/cdn.py::cdn_to_device``, all on the model's
    device; across ranks each rank's share of the global batch. ``metrics``:
    "loss_total" and every weighted loss term (0-d tensors, the global
    batch's), "finite" (bool) and "step" (int). ``model`` stays the plain
    module (the EMA, checkpoints and evaluation use it); ``net`` is what the
    forward calls, ``model`` inside DDP under a process group."""

    def __init__(self, model: nn.Module, optimizer: TrainOptimizer, num_body_points: int,
                 num_classes: int = 2, weight_dict: Optional[Dict[str, float]] = None,
                 matcher_backend: str = "auction", ema_decay: float = 0.9999,
                 ema_warmups: int = 2000, use_ema: bool = True,
                 losses: Sequence[str] = ("vfl", "keypoints"),
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        self.model = model.train()
        self.net = data_parallel(self.model)
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
        n_ranks = world()
        # gradients are all-reduced in the backward of the micro-batch that
        # completes the accumulation, the only one outside no_sync
        last = self.micro + 1 == self.optimizer.grad_accum_steps
        sync = (self.net.no_sync() if self.net is not self.model and not last
                else contextlib.nullcontext())
        forward, crit, backward, update = (span(n) for n in PHASES)
        with sync:
            with forward, torch.autocast(images.device.type, dtype=self.compute_dtype,
                                         enabled=amp):
                out = self.net(images, dn)
            with crit:
                terms = criterion_fn(out, targets, self.num_body_points, self.num_classes,
                                     weight_dict=self.weight_dict,
                                     matcher_backend=self.matcher_backend,
                                     losses=self.losses)
                if "energy_reg_loss" in out:
                    # the energy refinement's regulariser joins the total
                    # (JAX train_step.py:95-97) and is logged with the terms;
                    # a rank's is the mean over its share of the batch, so its
                    # share of the global mean is 1/world of it
                    terms["energy_reg_loss"] = out["energy_reg_loss"] / n_ranks
                total = torch.stack([v.float() for v in terms.values()]).sum()
                logged = torch.stack([total.detach()] + [v.detach().float()
                                                         for v in terms.values()]
                                     + [torch.isfinite(total).float()])
                logged = all_reduce_counts(logged)
                finite = bool(logged[-1] == n_ranks)
            self.step += 1
            if finite:
                with backward:
                    (total * n_ranks).backward()
        if finite:
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
        return {"loss_total": logged[0], "finite": finite, "step": self.step,
                **dict(zip(terms, logged[1:-1]))}


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
