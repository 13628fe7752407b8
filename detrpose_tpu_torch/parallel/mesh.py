"""The training model's data parallelism over the ranks.

Counterpart of ``detrpose_tpu/parallel/mesh.py``. JAX shards the batch over
a 1-D ``data`` mesh and lets XLA insert the gradient all-reduce; the port
runs one process per rank (``parallel/dist.py``) and wraps the training
model in ``DistributedDataParallel``, the reference's own parallelism
(src/misc/dist_utils.py:75-133). What pjit makes global without a word is
made global by hand: the BatchNorm statistics (``models/layers.py``), the
criterion's normalisers (``train/criterion.py``), the skip on a non-finite
loss (``parallel/train_step.py``) and the CDN group count
(``train/cdn.py::batch_cdn``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel


def data_parallel(model: nn.Module) -> nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` when a process group
    is initialised (one of one rank too), else ``model`` itself.

    Rank 0's parameters and floating buffers become every rank's: DDP's
    constructor broadcasts the parameters, and the buffers only when it
    broadcasts them at every forward too, which it does not here
    (``broadcast_buffers=False``): the BatchNorm statistics are moved by
    global statistics, the same on every rank. ``find_unused_parameters``
    is set because a training batch without a valid GT has no CDN block
    (``train/cdn.py::build_cdn`` returns None), and its forward leaves the
    CDN embeddings without a gradient on every rank, which DDP's reducer
    would otherwise wait for and fail at the next step.
    """
    if not dist.is_initialized():
        return model
    with torch.no_grad():
        for b in model.buffers():
            if b.is_floating_point():
                dist.broadcast(b, 0)
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=True)


# the CDN leaves that are the whole batch's, not one image's (JAX
# train/trainer.py::_REPL_LEAVES)
REPLICATED = ("attn_mask", "num_group", "active_mask", "pad_size", "num_dn_group")


def shard_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of a global training batch (the step's input):
    its contiguous slice of every per-image leaf, the replicated CDN leaves
    whole, as JAX's mesh shards a batch. The batch size must divide by
    ``world``."""
    def share(key, v):
        if isinstance(v, dict):
            return {k: share(k, x) for k, x in v.items()}
        if key in REPLICATED:
            return v
        if v.shape[0] % world:
            raise ValueError(f"shard_batch: {key} has {v.shape[0]} rows for {world} ranks")
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]
    return share(None, batch)
