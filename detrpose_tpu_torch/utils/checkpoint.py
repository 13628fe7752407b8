"""Checkpoints of the training state, through ``torch.save``.

Counterpart of ``detrpose_tpu/utils/checkpoint.py`` (an orbax checkpoint of
the TrainState). Reference semantics: the checkpoint dict {model, ema,
optimizer, lr_scheduler, epoch} written every epoch and on a new best
(src/solver/trainer.py:223-238), with full-state resume (:343-379). The file
keeps the reference's layout where it has one, so
``utils/convert.py::load_torch_checkpoint`` reads it as it reads a zoo
``.pth``:

  model       the model's state_dict (float32 master weights, BN statistics)
  ema         {"module": the EMA's state_dict (BN statistics averaged too),
              "updates": its update count}, or None without EMA
  optimizer   the AdamW state_dict
  optimizer_updates, step, micro   the optimiser steps taken, the training
              step's calls and its micro-batches since the last optimiser step
  grads       the gradients accumulated so far when ``micro`` > 0, else None
  epoch       the epoch that was finished

The learning rate is a function of ``optimizer_updates`` and the schedule of
the run that resumes, so a changed schedule takes effect on resume (as JAX,
whose lr is a function of the restored step).
"""
from __future__ import annotations

import os
import tempfile
import warnings
from typing import Dict, Optional

import torch

from .convert import load_torch_checkpoint, read_checkpoint


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def save_checkpoint(path: str, step, epoch: int) -> None:
    """Write ``step`` (a ``parallel/train_step.py::TrainStep``: its model,
    optimiser, EMA and counters) after ``epoch`` to ``path``, atomically: a
    reader finds the old file or the new one, never half of one."""
    model, opt = step.model, step.optimizer
    grads = None
    if step.micro:
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
    ckpt = {
        "model": _cpu(model.state_dict()),
        "ema": (None if step.ema is None else
                {"module": _cpu(step.ema.state_dict()), "updates": step.ema.updates}),
        "optimizer": opt.adamw.state_dict(),
        "optimizer_updates": opt.updates,
        "step": step.step,
        "micro": step.micro,
        "grads": grads,
        "epoch": int(epoch),
    }
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=os.path.dirname(path))
    os.close(fd)
    try:
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_variables(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The model's state_dict from a checkpoint, without an optimiser: the
    EMA weights with their BN statistics when there are any and
    ``prefer_ema`` (the reference's inference path, tools/inference/
    torch_inf.py:141-151), else the live ones. CPU tensors, for
    ``load_state_dict(strict=True)``."""
    return load_torch_checkpoint(path, prefer_ema=prefer_ema)


def _optimizer_state_for(opt, model, sd: Optional[dict]) -> Optional[dict]:
    """``sd`` as a state_dict of exactly ``opt.adamw``'s groups and parameter
    shapes, or None where it is not one (``load_state_dict`` checks the group
    sizes only). A state whose groups name their parameters
    (``utils/convert.py::optimizer_from_optax``) is mapped by name onto the
    groups' order, and fits only where each group holds the same names."""
    if sd is None:
        return None
    groups, saved = opt.adamw.param_groups, sd.get("param_groups", [])
    if len(groups) != len(saved) or any(len(g["params"]) != len(s["params"])
                                        for g, s in zip(groups, saved)):
        return None
    if all("param_names" in s for s in saved):
        name_of = {id(p): n for n, p in model.named_parameters()}
        state, out = {}, []
        for g, s in zip(groups, saved):
            index = dict(zip(s["param_names"], s["params"]))
            names = [name_of[id(p)] for p in g["params"]]
            if set(names) != set(index):
                return None
            params = list(range(len(state), len(state) + len(names)))
            for i, n in zip(params, names):
                if index[n] in sd["state"]:
                    state[i] = sd["state"][index[n]]
            out.append({k: v for k, v in s.items() if k != "param_names"} | {"params": params})
        sd = {"state": state, "param_groups": out}
    params = [p for g in groups for p in g["params"]]
    ids = [i for s in sd["param_groups"] for i in s["params"]]
    for p, i in zip(params, ids):
        st = sd.get("state", {}).get(i)
        if st is not None and any(torch.is_tensor(v) and v.dim() and v.shape != p.shape
                                  for v in st.values()):
            return None
    return sd


def restore_checkpoint(path: str, step) -> int:
    """Restore ``step`` (a ``TrainStep``) from ``path`` in place and return
    the epoch it was saved after.

    The model, the EMA and the counters always load. The AdamW state and
    accumulated gradients load when they fit the current optimiser, this
    package's own or one converted from the JAX package's optax state (an
    orbax directory, converted in memory by ``read_checkpoint``, or its
    ``.pth``); the groups' hyperparameters stay the current run's, as JAX's,
    whose optax state carries none. When the state does not fit (another
    freeze setting, other groups) or there is none, the weights and EMA are
    kept, the optimiser starts fresh, and a warning says so (reference:
    src/solver/trainer.py:358-361; JAX's ``restore_checkpoint`` fallback).
    """
    ckpt = read_checkpoint(path)
    model, opt = step.model, step.optimizer
    model.load_state_dict(ckpt["model"], strict=True)
    if step.ema is not None:
        ema: Optional[dict] = ckpt.get("ema")
        sd = ema["module"] if ema is not None else ckpt["model"]
        with torch.no_grad():
            for store in (step.ema.params, step.ema.buffers):
                for k, v in store.items():
                    v.copy_(sd[k])
        step.ema.updates = ema["updates"] if ema is not None else 0
    step.step = int(ckpt["step"])
    opt.updates = int(ckpt["optimizer_updates"])
    opt.zero_grad()
    state = _optimizer_state_for(opt, model, ckpt["optimizer"])
    if state is not None:
        hyper = [{k: v for k, v in g.items() if k != "params"} for g in opt.adamw.param_groups]
        opt.adamw.load_state_dict(state)
        for g, h in zip(opt.adamw.param_groups, hyper):
            g.update(h)
        step.micro = int(ckpt["micro"])
        named = dict(model.named_parameters())
        for n, g in (ckpt.get("grads") or {}).items():
            named[n].grad = g.to(named[n].device)
    else:
        opt.adamw.state.clear()
        step.micro = 0
        what = ("carries no optimizer state" if ckpt["optimizer"] is None else
                "has an optimizer state that does not match the current optimizer")
        warnings.warn(f"the checkpoint {what}; restored the weights and EMA only and kept "
                      f"a fresh optimizer (reference trainer.py:358-361)", stacklevel=2)
    return int(ckpt["epoch"])
