"""Batch assembly: host-side loader turning dataset samples into padded numpy
batches (images NHWC float32 in [0, 1], padded targets, optional CDN), which
``train/trainer.py`` moves to the device.

The port of ``detrpose_tpu/data/loader.py``, which replaces the reference's
torch DataLoader + BatchImageCollateFunction (src/data/dataloader.py):
multi-scale collate is a per-batch random choice from ``generate_scales``
until ``stop_epoch`` (dataloader.py:56-61, 97-106). The same seeds give the
same order, items, scales and CDN queries as the JAX loader; the multi-scale
resize is ``F.interpolate(mode="bilinear", antialias=True)``, the function
the JAX loader's PIL mode-"F" resize was written to match.

Worker pools end without ``Pool.terminate()``: on an early exit the gate that
feeds the pool is told to stop and opened, so the pool's task handler leaves
it, and the pool is closed and joined within a deadline (``_close_pool``).
The JAX loader terminates the pool while its task handler may be parked in
the gate, which can hang.

With more than one process the batches leave their CDN block unbuilt:
``batch["make_cdn"](max_known=...)`` builds it once the largest GT count
over the ranks is known, so every rank has the same group count.

This module imports no torch at import time: the pool's worker processes
import it to load items, and need only numpy and PIL.
"""
from __future__ import annotations

import functools
import logging
import multiprocessing
import os
import queue
import random
import sys
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .coco import normalize_target, pad_targets

log = logging.getLogger(__name__)


def generate_scales(base_size: int, base_size_repeat: int) -> List[int]:
    """Reference: src/data/dataloader.py:56-61 (±25% in steps of 32)."""
    scale_repeat = (base_size - int(base_size * 0.75 / 32) * 32) // 32
    scales = [int(base_size * 0.75 / 32) * 32 + i * 32 for i in range(scale_repeat)]
    scales += [base_size] * base_size_repeat
    scales += [int(base_size * 1.25 / 32) * 32 - i * 32 for i in range(scale_repeat)]
    return scales


def shard_indices(order: Sequence[int], process_index: int,
                  process_count: int) -> List[int]:
    """Strided per-process slice of a (globally shuffled) index order, padded
    by wrapping so every process sees the same number of samples
    (DistributedSampler semantics, reference dist_utils.py:98-108; the JAX
    package's ``parallel/dist.py::shard_indices``)."""
    order = list(order)
    if process_count <= 1:
        return order
    n = len(order)
    per = -(-n // process_count)  # ceil
    padded = order + order[: per * process_count - n]
    return padded[process_index::process_count]


# ---- worker-pool item loading ------------------------------------------
# The reference trains with DataLoader(num_workers=4)
# (configs/detrpose/include/dataset.py:48): decode and the augmentation
# policy (mosaic decodes 4 extra images) cannot keep the card fed from one
# Python thread. A per-epoch pool of worker processes is created after
# set_epoch, so the pickled dataset carries the epoch's policy state; each
# item re-seeds the transform RNG from (seed, epoch, index), so results are
# deterministic and independent of worker scheduling, and equal the JAX
# loader's worker items.
_WORKER_DS = None
_WORKER_CFG = None


def _worker_init(ds, num_keypoints, seed, epoch):
    global _WORKER_DS, _WORKER_CFG
    _WORKER_DS = ds
    _WORKER_CFG = (num_keypoints, seed, epoch)


def item_seed(seed: int, epoch: int, idx: int) -> int:
    """The transform RNG's seed of item ``idx`` in a worker. Large odd
    multipliers, so (epoch, idx) pairs never collide for any realistic
    dataset size (a small epoch multiplier would replay item i of epoch e as
    item i - mult of epoch e + 1 on datasets larger than it, e.g. COCO's
    118k)."""
    return seed * 0x9E3779B97F4A7C15 + epoch * 0x2545F4914F6CDD1D + idx


def _load_item(idx):
    ds, (K, seed, epoch) = _WORKER_DS, _WORKER_CFG
    tf = getattr(ds, "transforms", None)
    if tf is not None and hasattr(tf, "rng"):
        tf.rng = random.Random(item_seed(seed, epoch, idx))
    img, t = ds[idx]
    # A pipeline that kept pixels uint8 (PIL) ships them as uint8: 4x less
    # IPC than float32, dequantized once per batch in the parent. A
    # float-producing pipeline is assumed to carry 0-255 pixel values (the
    # in-process path's contract) and is normalized to [0, 1] here.
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.asarray(img, np.float32) / 255.0
    h, w = arr.shape[:2]
    return arr, normalize_target(t, w, h, K)


class _Gate:
    """Bounds the items a pool has been sent but the consumer has not taken
    (``Pool.imap`` would dispatch the whole epoch and buffer every result:
    torch's DataLoader bounds this to prefetch_factor * num_workers), and
    lets the consumer stop the feed: after ``stop()`` the generator ends at
    its next item, so the pool's task-handler thread, which runs it, leaves
    it instead of waiting in ``acquire``."""

    def __init__(self, bound: int):
        self.sem = threading.Semaphore(bound)
        self.stopped = threading.Event()

    def feed(self, seq):
        for x in seq:
            self.sem.acquire()
            if self.stopped.is_set():
                return
            yield x

    def taken(self):
        self.sem.release()

    def stop(self):
        self.stopped.set()
        self.sem.release()   # wakes a task handler parked in acquire


def _pool_context():
    """The "forkserver" context, its server preloading this module and the
    program's main module. Not "fork": the parent has threads (the
    Prefetcher's, torch's), and a fork can inherit a held lock. Not "spawn":
    each worker of each epoch would import the main module and its imports
    afresh (torch, the model code: 4 spawned workers of chip_smoke.py took
    32 s to their first batch on the H100's host). The server imports them
    once per process and forks each epoch's workers from itself, single
    threaded. Python 3.12's forkserver does not preload ``__main__`` itself
    (it asks for a key the preparation data does not have), so the main
    module is named: its module name under ``-m``, its file's stem when run
    as a script (importable: its directory is on sys.path). A main module
    without an ``if __name__ == "__main__":`` guard cannot use workers with
    any start method but fork."""
    preload = [__name__]
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    name = (spec.name if spec is not None
            else os.path.splitext(os.path.basename(getattr(main, "__file__", "") or ""))[0])
    if name and not name.endswith("__main__"):
        preload.append(name)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(preload)   # no-op once the server runs
    return ctx


def _close_pool(pool, gate: _Gate, deadline_s: float) -> bool:
    """Stop the gate, close the pool and join it within ``deadline_s``.
    The workers finish the items already sent (at most the gate's bound).
    Returns False, and leaves the daemonic workers to end with the process,
    if the join did not finish in time; never terminates the pool."""
    gate.stop()
    pool.close()
    joiner = threading.Thread(target=pool.join, daemon=True)
    joiner.start()
    joiner.join(deadline_s)
    if joiner.is_alive():
        log.warning("data worker pool did not close within %.0f s; leaving its "
                    "daemonic workers to end with the process", deadline_s)
        return False
    return True


class KeypointLoader:
    """Epoch-based loader; ``num_workers`` spins up a per-epoch pool of
    worker processes (``_pool_context``) for item decode + transform (0 =
    in-process, one sequential augmentation stream, as the JAX loader's)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_keypoints: int = 17,
        train: bool = False,
        max_gt: int = 64,
        base_size: int = 640,
        base_size_repeat: Optional[int] = None,
        multiscale_stop_epoch: int = 48,
        with_cdn: bool = True,
        num_queries: int = 60,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 0,
    ):
        self.num_workers = num_workers
        self.worker_timeout = 300.0  # seconds per item fetch before erroring
        self.close_timeout = 60.0    # seconds to join the pool at the end of an epoch
        self.ds = dataset
        self.bs = batch_size
        self.K = num_keypoints
        self.train = train
        self.max_gt = max_gt
        self.base_size = base_size
        self.scales = (
            generate_scales(base_size, base_size_repeat)
            if (train and base_size_repeat) else None
        )
        self.multiscale_stop_epoch = multiscale_stop_epoch
        self.with_cdn = with_cdn and train
        self.num_queries = num_queries
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        # Strided per-process shard of the (identically shuffled) global
        # order; batch_size is per process (reference get_rank_batch_size,
        # src/solver/trainer.py:70-85).
        self.process_index = process_index
        self.process_count = max(process_count, 1)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.ds, "transforms") and hasattr(self.ds.transforms, "set_epoch"):
            self.ds.transforms.set_epoch(epoch)

    def _shard_len(self):
        n = len(self.ds)
        if self.process_count > 1:
            n = -(-n // self.process_count)  # ceil: wrap-padded shards
        return n

    def __len__(self):
        n = self._shard_len()
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(self.seed + self.epoch)
        nprng = np.random.default_rng(
            self.seed + self.epoch + 7919 * self.process_index)
        order = list(range(len(self.ds)))
        if self.train:
            rng.shuffle(order)
        order = shard_indices(order, self.process_index, self.process_count)
        if self.num_workers > 0 and self.drop_last:
            # only whole batches go to the pool (an empty order, when the
            # shard is smaller than one batch, spins up no pool)
            order = order[: (len(order) // self.bs) * self.bs]
        if not (self.num_workers > 0 and order):
            yield from self._iter_batches(order, rng, nprng, None, None)
            return
        pool = _pool_context().Pool(self.num_workers, initializer=_worker_init,
                                    initargs=(self.ds, self.K, self.seed, self.epoch))
        gate = _Gate(max(4 * self.num_workers, 2 * self.bs))
        try:
            # chunksize=1: imap's iterator then has next(timeout), and
            # chunking gains nothing on image-sized payloads
            items = pool.imap(_load_item, gate.feed(order), chunksize=1)
            yield from self._iter_batches(order, rng, nprng, items, gate)
        finally:
            _close_pool(pool, gate, self.close_timeout)

    def _next_item(self, items, gate: _Gate):
        try:
            arr, t = items.next(timeout=self.worker_timeout)
        except multiprocessing.TimeoutError:
            raise RuntimeError(
                f"data worker produced no item within {self.worker_timeout}s. "
                f"If your training script uses num_workers>0, its entry point must "
                f"be wrapped in `if __name__ == '__main__':` (the workers "
                f"import __main__).") from None
        gate.taken()
        if arr.dtype == np.uint8:  # dequantize uint8 IPC payloads
            arr = arr.astype(np.float32) / 255.0
        return arr, t

    def _iter_batches(self, order, rng, nprng, items, gate):
        for start in range(0, len(order) - (self.bs - 1 if self.drop_last else 0), self.bs):
            idxs = order[start:start + self.bs]
            imgs, tgts = [], []
            for i in idxs:
                if items is not None:
                    arr, t = self._next_item(items, gate)
                else:
                    img, t = self.ds[i]
                    arr = np.asarray(img, np.float32) / 255.0
                    h, w = arr.shape[:2]
                    t = normalize_target(t, w, h, self.K)
                imgs.append(arr)
                tgts.append(t)
            images = np.stack(imgs)  # (B, H, W, 3)

            # per-batch multi-scale resize (train only, before stop_epoch)
            if self.scales and self.epoch < self.multiscale_stop_epoch:
                s = rng.choice(self.scales)
                if s != images.shape[1]:
                    images = _resize_batch(images, s)

            batch = {
                "images": images,
                "targets": pad_targets(tgts, self.max_gt),
                "image_ids": np.asarray([t["image_id"] for t in tgts]),
                "orig_sizes": np.stack([t["orig_size"] for t in tgts]),
            }
            if self.with_cdn:
                from ..train.cdn import CDNConfig, build_cdn

                # CDN label flips are independent of the model's head classes
                # (the reference hard-codes num_classes=80 in prepare_for_cdn,
                # transformer.py:1271); CDNConfig carries that default.
                make = functools.partial(build_cdn, batch["targets"], self.num_queries,
                                         self.K, images.shape[1:3], nprng, CDNConfig())
                if self.process_count > 1:
                    # the group count is the global batch's, which the
                    # consumer learns from the other ranks before it builds
                    # (train/cdn.py::batch_cdn), on this RNG stream in batch order
                    batch["make_cdn"] = make
                else:
                    dn = make()
                    if dn is not None:
                        batch["dn"] = dn
            yield batch


class Prefetcher:
    """Background-thread batch prefetch so host batch assembly overlaps the
    device's work (the pool parallelizes item decode + transform across
    processes; this thread takes the batch assembly off the training loop's
    thread).

    Usage: ``for batch in Prefetcher(loader, depth=2): ...``. A loader error
    is raised in the consumer.
    """

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        err = []
        stop = threading.Event()
        inner = iter(self.loader)

        def put(item) -> bool:
            # a put that wakes when the consumer leaves, so this thread never
            # parks in q.put holding the loader generator (and its pool) open
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not stop.is_set():
                    try:
                        b = next(inner)
                    except StopIteration:
                        break
                    if not put(b):
                        break
            except BaseException as e:  # surface loader errors in the consumer
                err.append(e)
            finally:
                try:
                    inner.close()   # the loader's pool teardown, however the epoch ends
                except Exception:
                    log.exception("closing the loader failed")
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is end:
                    break
                yield b
        finally:
            # normal end, consumer break/exception, or generator close: stop
            # the worker and wait for the pool teardown, bounded (a stalled
            # worker keeps an item fetch waiting up to worker_timeout)
            stop.set()
            t.join(getattr(self.loader, "worker_timeout", 300.0)
                   + getattr(self.loader, "close_timeout", 60.0) + 10.0)
            if t.is_alive():
                log.warning("Prefetcher worker did not stop within the join bound; "
                            "abandoning it (daemon thread).")
            if err and sys.exc_info()[0] is GeneratorExit:
                # the consumer closed the generator: the raise below never
                # runs, so say what is dropped
                log.warning("Prefetcher loader error dropped on close: %r", err[0])
        if err:
            raise err[0]


def _resize_batch(images: np.ndarray, size: int) -> np.ndarray:
    """Antialiased bilinear resize of the collated float batch (B, H, W, 3)
    to (B, size, size, 3): ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)`` on the CPU, the reference's
    torchvision F.resize of the stacked float tensor (dataloader.py:4,105).
    Full float precision, no uint8 round trip."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return np.ascontiguousarray(y.permute(0, 2, 3, 1).numpy())
