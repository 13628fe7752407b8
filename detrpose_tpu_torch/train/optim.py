"""Optimiser, learning-rate schedule and EMA.

Counterpart of ``detrpose_tpu/train/optim.py``, whose optax arithmetic the
AdamW step follows (``AdamW``). Reference semantics:
  * AdamW lr 1e-4, betas (0.9, 0.999), weight decay 1e-4, with the backbone in
    a group of its own at lr 1e-5 (src/misc/get_param_dicts.py:8-40);
  * MultiStepLR (milestones in optimiser steps, gamma) with an optional
    linear warm-up (src/nn/optimizer/warmup.py);
  * global-norm gradient clipping at 0.1 (engine.py:82-85);
  * ModelEMA with the ramp decay * (1 - exp(-updates / warmups)), over the
    parameters and the BatchNorm running statistics (ema.py:20-67).

Gradient accumulation (engine.py:43-85): the micro-batch losses are not
divided by k, so ``.grad`` holds the sum of the k micro-batch gradients, and
the clip applies to that sum before the step (JAX: ``optax.scale(k)``, the
clip, then ``MultiSteps``). ``parallel/train_step.py`` calls
``TrainOptimizer.step`` once per k finite micro-batches.

Frozen parameters (the backbone's BatchNorm affine parameters, and those of
``freeze_at`` / ``freeze_backbone``) are in no group: they keep their values.
Their gradients still count in the clip's global norm, as in JAX, where the
clip runs before the per-group transforms.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import BatchNorm


def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                       warmup_steps: int = 0) -> Callable[[int], float]:
    """lr at optimiser step ``step`` (0 for the first): ``base_lr`` times gamma
    per milestone passed, times min(step / warmup_steps, 1) under warm-up."""
    def schedule(step: int) -> float:
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr *= gamma
        if warmup_steps > 0:
            lr *= min(max(step / warmup_steps, 0.0), 1.0)
        return lr
    return schedule


def resolve_backbone_freeze(backbone_name: str, freeze_at: int = -1,
                            freeze_stem_only: bool = True,
                            freeze_backbone: bool = False) -> Tuple[int, bool]:
    """Backbone-family freeze defaults. The reference ResNet freezes everything
    outside layer2/3/4 (resnet.py:64-66), which maps onto (freeze_at=0,
    freeze_stem_only=False) when no freeze_at was asked for; HGNetv2 trains
    everything by default (include/detrpose_hgnetv2.py:34-35)."""
    if (backbone_name.startswith("resnet") and freeze_at < 0
            and not freeze_backbone):
        return 0, False
    return freeze_at, freeze_stem_only


def label_parameters(model: nn.Module, freeze_backbone_norm: bool = True,
                     freeze_at: int = -1, freeze_stem_only: bool = True,
                     freeze_backbone: bool = False) -> Dict[str, str]:
    """Each parameter's group by name: "main", "backbone" or "frozen" (JAX
    ``make_optimizer.label_fn``). ``freeze_at >= 0`` freezes the stem and,
    unless ``freeze_stem_only``, stages 0..freeze_at; ``freeze_backbone_norm``
    the backbone's BatchNorm affine parameters (FrozenBatchNorm2d)."""
    bn_params = {f"{name}.{p}" for name, m in model.named_modules()
                 if isinstance(m, BatchNorm) for p in ("weight", "bias")}
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "backbone":
            labels[name] = "main"
            continue
        # HGNetv2: stem, stages.{i}; ResNet: conv1, bn1, layer{i+1}_{block}
        stage = (-1 if parts[1] in ("stem", "conv1", "bn1") else
                 int(parts[2]) if parts[1] == "stages" else
                 int(parts[1][len("layer"):].split("_")[0]) - 1
                 if parts[1].startswith("layer") else None)
        frozen = freeze_backbone
        if freeze_at >= 0 and stage is not None:
            frozen |= stage == -1 or (not freeze_stem_only and stage <= freeze_at)
        frozen |= freeze_backbone_norm and name in bn_params
        labels[name] = "frozen" if frozen else "backbone"
    return labels


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW``'s groups and state (``step``, ``exp_avg``,
    ``exp_avg_sq``, so its state_dict), stepped in optax ``adamw``'s float32
    arithmetic, JAX ``make_optimizer``'s: m = (1 - b1) g + b1 m and
    v = (1 - b2) g^2 + b2 v, their bias corrections 1 - b ** t in float32,
    u = (m / bc1) / (sqrt(v / bc2) + eps) + wd p, and p = p + (-lr) u.
    torch's own step takes the bias corrections in float64 and decays p
    first, which moves an update by up to ~1e-5 relative from optax's in the
    first thousand steps (optax's float32 1 - b2 ** t is that far from exact).
    The moments update in place as torch's foreach step does them (``lerp_``,
    ``addcmul_``), within a unit in the last place of optax's; a step makes
    two temporaries the size of the parameters. Only the hyperparameters
    above are taken: the step has no amsgrad, maximize, fused or capturable
    form."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(
                        step=torch.tensor(0.0, dtype=torch.float32),
                        exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                        exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
            state = [self.state[p] for p in params]
            steps = [st["step"] for st in state]
            torch._foreach_add_(steps, 1)
            t = torch.stack(steps).float().cpu()
            (b1, b2), grads = group["betas"], [p.grad for p in params]
            bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** t).tolist()
            bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** t).tolist()
            mus, nus = [st["exp_avg"] for st in state], [st["exp_avg_sq"] for st in state]
            torch._foreach_lerp_(mus, grads, 1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, den)
            del den
            if group["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, upd, alpha=-group["lr"])
        return None


class TrainOptimizer:
    """``AdamW`` over the "main" and "backbone" groups, with their
    schedules, the global-norm clip and the accumulation count.

    ``step()`` sets each group's lr for this optimiser step, clips the summed
    gradients of every parameter, steps AdamW and clears the gradients;
    ``updates`` counts the steps taken."""

    def __init__(self, adamw: AdamW, schedules: List[Callable[[int], float]],
                 params: List[nn.Parameter], clip_max_norm: float, grad_accum_steps: int):
        self.adamw = adamw
        self.schedules = schedules
        self.params = params
        self.clip_max_norm = clip_max_norm
        self.grad_accum_steps = max(int(grad_accum_steps), 1)
        self.updates = 0

    @torch.no_grad()
    def clip_(self) -> Optional[torch.Tensor]:
        """Scale every gradient by max_norm / norm where the global norm
        exceeds max_norm (optax ``clip_by_global_norm``); returns the norm
        (float32). The norms accumulate in float64: a float32 norm of a large
        tensor on the CPU is off by a few 1e-6, where optax's global norm
        is within 2e-7."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads or not self.clip_max_norm or self.clip_max_norm <= 0:
            return None
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))).float()
        factor = torch.where(norm < self.clip_max_norm, 1.0, self.clip_max_norm / norm)
        torch._foreach_mul_(grads, factor)
        return norm

    def step(self) -> Optional[torch.Tensor]:
        for group, schedule in zip(self.adamw.param_groups, self.schedules):
            group["lr"] = schedule(self.updates)
        norm = self.clip_()
        self.adamw.step()
        self.zero_grad()
        self.updates += 1
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(model: nn.Module, base_lr: float = 1e-4, backbone_lr: float = 1e-5,
                   betas=(0.9, 0.999), weight_decay: float = 1e-4,
                   clip_max_norm: float = 0.1, milestones: Sequence[int] = (),
                   gamma: float = 0.1, warmup_steps: int = 0, grad_accum_steps: int = 1,
                   freeze_backbone_norm: bool = True, freeze_at: int = -1,
                   freeze_stem_only: bool = True,
                   freeze_backbone: bool = False) -> TrainOptimizer:
    """AdamW with the backbone's lr, the freeze masks, the clip and the
    MultiStep schedule (JAX ``make_optimizer``)."""
    labels = label_parameters(model, freeze_backbone_norm, freeze_at, freeze_stem_only,
                              freeze_backbone)
    named = dict(model.named_parameters())
    groups = [{"params": [p for n, p in named.items() if labels[n] == g], "lr": lr}
              for g, lr in (("main", base_lr), ("backbone", backbone_lr))]
    groups = [g for g in groups if g["params"]]
    adamw = AdamW(groups, lr=base_lr, betas=tuple(betas), eps=1e-8, weight_decay=weight_decay)
    schedules = [multistep_schedule(g["lr"], milestones, gamma, warmup_steps)
                 for g in groups]
    return TrainOptimizer(adamw, schedules, list(named.values()), clip_max_norm,
                          grad_accum_steps)


class EMA:
    """Exponential moving average of the parameters and the floating buffers
    (the BatchNorm running statistics), as the reference's ModelEMA averages
    the whole state_dict (ema.py:55-67). ``update`` blends with
    d = decay * (1 - exp(-updates / warmups)), in float32 as JAX does."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, warmups: int = 2000):
        self.decay, self.warmups = decay, warmups
        self.params = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.buffers = {n: b.detach().clone() for n, b in model.named_buffers()
                        if b.is_floating_point()}
        self.updates = 0

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.updates += 1
        d = float(np.float32(self.decay) * (np.float32(1.0) - np.exp(
            -np.float32(self.updates) / np.float32(self.warmups))))
        cur = dict(model.named_parameters())
        cur.update(model.named_buffers())
        ema = list(self.params.values()) + list(self.buffers.values())
        new = [cur[n] for n in list(self.params) + list(self.buffers)]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [t.to(e.dtype) for t, e in zip(new, ema)], alpha=1.0 - d)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The averaged weights, loadable into the model with strict=True."""
        return {**self.params, **self.buffers}
