"""Data-parallel ranks: the process group, and what crosses between ranks.

Counterpart of ``detrpose_tpu/parallel/dist.py``, which replaces the
reference's NCCL bootstrap (src/misc/dist_utils.py:44-133) with
``jax.distributed``. The port runs one process per rank under
``torch.distributed``, as the reference does:

  * ``init_distributed`` joins the process group that torchrun's or SLURM's
    environment describes (a no-op without one);
  * ``gather_lists`` and ``merge_detections`` concatenate and merge per-rank
    evaluation results, first rank wins (the loader's
    ``data/loader.py::shard_indices`` wrap-pads the shards, so an image can
    be evaluated on two ranks);
  * ``all_reduce_counts`` sums (or takes the min or max of) a few scalars:
    the criterion's normalisers and the matcher's auction scale, the step's
    loss terms and finite flags, the CDN group count;
  * ``gather_across_ranks`` stacks a tensor of every rank's, with a
    gradient, for SyncBN;
  * ``run_ranks`` spawns ranks on one machine and joins them under a
    deadline (tests and the smoke run).

With no process group, or one of one rank, every collective here returns
its input.
"""
from __future__ import annotations

import os
import pickle
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _env_ranks():
    """(rank, world, local rank) from torchrun's or SLURM's variables, or None."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)))
    return None


def init_distributed(device: torch.device | str = "cuda",
                     backend: Optional[str] = None) -> tuple:
    """Join the process group the environment describes; returns (rank,
    world). Safe to call again once joined.

    Recognised, first match wins: torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (the reference's dist_utils.py:44-56), or SLURM's
    ``SLURM_PROCID``, ``SLURM_NTASKS`` > 1 and ``SLURM_LOCALID``
    (:57-63); both rendezvous at ``MASTER_ADDR``:``MASTER_PORT``. With
    neither it does nothing and returns (0, 1).

    The backend is ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU
    unless ``backend`` names one. On CUDA the rank's card is ``LOCAL_RANK``
    (SLURM's local id), made the current device before the group starts.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    ranks = _env_ranks()
    if ranks is None:
        return 0, 1
    rank, world, local = ranks
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(local)
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"init_distributed: {var} is not set; launch with "
                               f"`python -m torch.distributed.run` or set it")
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", rank=rank, world_size=world)
    return rank, world


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, which alone writes logs, checkpoints and results."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world() > 1:
        dist.barrier()


def all_reduce_counts(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum, min or max over the ranks of ``t`` (a few scalars; no
    gradient), a new tensor; ``t`` itself with one rank."""
    if world() <= 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=_OPS[op])
    return out


class _GatherAcrossRanks(torch.autograd.Function):
    """All-gather whose backward sends each rank the sum over the ranks of
    the upstream gradient at its own row: every rank's input gets the
    gradient of every rank's loss."""

    @staticmethod
    def forward(ctx, t):
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t.contiguous())
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[dist.get_rank()]


def gather_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order (world, ...), differentiable
    (``t[None]`` with one rank)."""
    return _GatherAcrossRanks.apply(t) if world() > 1 else t[None]


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's byte string, in rank order (the reference's pickle
    all_gather, misc/logger.py:77-117)."""
    out: List[Optional[bytes]] = [None] * world()
    dist.all_gather_object(out, payload)
    return out


def gather_lists(items: list, allgather: Optional[Callable] = None, dedup_key=None) -> list:
    """Concatenate a per-rank list over the ranks, on every rank (the
    test-dev results.json, reference src/solver/engine.py:143-157).

    ``dedup_key``: optional ``item -> hashable``; an item whose key appeared
    in an earlier rank's list is dropped (first rank wins: the wrap-padded
    shards evaluate up to world-1 images twice; the reference dedups merged
    images with np.unique, coco_eval.py:228). ``allgather`` (bytes -> list of
    every rank's bytes) is injectable for tests."""
    if allgather is None:
        if world() <= 1:
            return list(items)
        allgather = _allgather_bytes
    out: list = []
    seen: set = set()
    for blob in allgather(pickle.dumps(list(items))):
        chunk = pickle.loads(blob)
        if dedup_key is None:
            out.extend(chunk)
            continue
        mine = set()
        for item in chunk:
            k = dedup_key(item)
            if k in seen:
                continue
            mine.add(k)
            out.append(item)
        seen |= mine
    return out


def merge_detections(dets: Dict[int, list], allgather: Optional[Callable] = None
                     ) -> Dict[int, list]:
    """Merge the evaluator's per-rank detections (image id -> list), the
    same merged dict on every rank (reference coco_eval.py:93-105); first
    rank wins per image id. ``allgather`` as ``gather_lists``."""
    if allgather is None:
        if world() <= 1:
            return dets
        allgather = _allgather_bytes
    merged: Dict[int, list] = {}
    for blob in allgather(pickle.dumps(dets)):
        for img, d in pickle.loads(blob).items():
            if img not in merged:
                merged[img] = list(d)
    return merged


# ---- ranks on one machine ------------------------------------------------
def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(index, fn, world_size, port, device, backend, local_ranks, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(index),
                      WORLD_SIZE=str(world_size), LOCAL_RANK=str(local_ranks[index]))
    init_distributed(device, backend)
    try:
        fn(index, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), deadline_s: float = 120.0,
              device: torch.device | str = "cpu", backend: Optional[str] = None,
              local_ranks: Optional[Sequence[int]] = None) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group on a fresh localhost port, and
    wait for all of them.

    ``fn`` must be importable by name (a module-level function). On CUDA
    ``local_ranks`` names each rank's card (``range(world_size)`` by default;
    ``[0, 0]`` puts two ranks on one card, which only gloo allows). Raises
    the first rank's error with its traceback if a rank fails, and
    ``TimeoutError`` if the ranks have not all ended within ``deadline_s``,
    after killing every one: a hang fails, it does not wait."""
    import torch.multiprocessing as mp

    local = list(range(world_size) if local_ranks is None else local_ranks)
    ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False,
                             start_method="spawn",
                             args=(fn, world_size, free_port(), str(device), backend, local,
                                   tuple(args)))
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not end within {deadline_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
