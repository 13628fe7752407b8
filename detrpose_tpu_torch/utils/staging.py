"""A batch of host frames sent to a CUDA device through pinned memory.

A copy from pageable memory goes through CUDA's own pinned buffer,
filled by one host thread, and holds the host until it ends. ``StagedUpload``
copies each request into a pinned arena of its own instead, in chunks of
whole frames, on a few host threads, and sends each chunk to the device
with an asynchronous copy as soon as its host copy is done: the device
copies chunk k while the host copies chunk k + 1.

  up = StagedUpload(torch.device("cuda"))
  img, wh = up(frames, sizes)     # device tensors; frames (B, H, W, 3) uint8

Every call copies all of its input: nothing is kept or registered by the
caller's buffer, which is free again when the call returns. Before a worker
writes a range of the arena again, the copies that read it in earlier calls
have ended (their events). One call at a time. On the CPU the same code
copies synchronously out of a plain arena; the serving entry does not use
it there.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# a chunk's size aimed at: a few ms of host copy, so the first chunk's copy
# to the device starts early and the last one's, which nothing hides, is short
CHUNK_BYTES = 16 << 20
# each piece starts in the arena at a multiple of this, which any dtype's view accepts
ALIGN = 64


def copy_workers() -> int:
    """Host threads that copy into the arena: half the usable CPUs, at most
    4, and at least one."""
    return max(1, min(4, len(os.sched_getaffinity(0)) // 2))


def chunks(n_frames: int, frame_bytes: int, workers: int) -> List[Tuple[int, int]]:
    """The [first, end) frames of each chunk: about ``CHUNK_BYTES`` each, as
    many as a whole number of rounds of ``workers`` takes, whole frames; one
    chunk for a request of one chunk's size or less."""
    n = math.ceil(n_frames * frame_bytes / CHUNK_BYTES)
    if n > 1:
        n = workers * math.ceil(n / workers)
    n = max(1, min(n, n_frames))
    ends = [n_frames * i // n for i in range(n + 1)]
    return list(zip(ends[:-1], ends[1:]))


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of the contiguous tensor ``t``, flat."""
    return t.view(-1).view(torch.uint8)


class StagedUpload:
    """Frames and their sizes from the host to ``device``, through a pinned
    arena (a plain one on the CPU) that grows to the largest request seen,
    copied into by a pool of ``copy_workers()`` threads."""

    def __init__(self, device: torch.device):
        self.device = device
        self.workers = copy_workers()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._arena = torch.empty(0, dtype=torch.uint8)
        self._sent: list = []       # (first byte, end byte, event) of earlier calls' copies

    def __call__(self, img_u8: Union[np.ndarray, torch.Tensor],
                 orig_wh: Union[np.ndarray, torch.Tensor, Sequence[float]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(frames, sizes as float32) on the device. Frames already on a CUDA
        device are not copied; pinned ones are copied to the device directly,
        before the call returns."""
        wh = np.asarray(orig_wh, np.float32)
        wh_d = torch.empty(wh.shape, dtype=torch.float32, device=self.device)
        if isinstance(img_u8, torch.Tensor) and (img_u8.is_cuda or img_u8.is_pinned()):
            self._upload([(wh, as_bytes(wh_d))])
            return img_u8.to(self.device), wh_d
        src = img_u8.numpy() if isinstance(img_u8, torch.Tensor) else np.asarray(img_u8)
        batch = src[None] if src.ndim == 3 else src
        img = torch.empty(src.shape, dtype=torch.from_numpy(np.empty(0, src.dtype)).dtype,
                          device=self.device)
        flat, size = as_bytes(img), batch[0].nbytes if len(batch) else 0
        self._upload([(batch[i:j], flat[i * size:j * size])
                      for i, j in chunks(len(batch), size, self.workers)]
                     + [(wh, as_bytes(wh_d))])
        return img, wh_d

    def _upload(self, pieces: List[Tuple[np.ndarray, torch.Tensor]]) -> None:
        """Each host array of ``pieces`` into the arena, one after the other,
        and from there into its device bytes, in order."""
        starts, end = [], 0
        for src, _ in pieces:
            starts.append(end)
            end += ALIGN * math.ceil(src.nbytes / ALIGN)
        if self._arena.numel() < end:
            # the old arena's copies keep its memory until they end (the
            # caching host allocator records them), so nothing waits here
            self._arena = torch.empty(end, dtype=torch.uint8,
                                      pin_memory=self.device.type == "cuda")
            self._sent = []
        host, earlier = self._arena.numpy(), self._sent

        def fill(lo: int, src: np.ndarray) -> None:
            hi = lo + src.nbytes
            for a, b, ev in earlier:
                if a < hi and lo < b:
                    ev.synchronize()
            np.copyto(host[lo:hi].view(src.dtype).reshape(src.shape), src)

        parallel = self.workers > 1 and len(pieces) > 2     # more than one chunk of frames
        if parallel and self._pool is None:
            self._pool = ThreadPoolExecutor(self.workers, thread_name_prefix="upload")
        jobs, sent = [], []
        try:
            if parallel:
                jobs = [self._pool.submit(fill, lo, src) for lo, (src, _) in zip(starts, pieces)]
            for k, (lo, (src, dst)) in enumerate(zip(starts, pieces)):
                if jobs:
                    jobs[k].result()
                else:
                    fill(lo, src)
                sent.append((lo, lo + src.nbytes,
                             self._send(dst, self._arena[lo:lo + src.nbytes])))
        finally:
            wait(jobs)
            self._sent = ([s for s in earlier if not s[2].query()]
                          + [s for s in sent if s[2] is not None])

    def _send(self, dst: torch.Tensor, src: torch.Tensor):
        """Copy the arena's bytes ``src`` into ``dst`` on the current stream;
        the event that marks the copy's end, None where it has ended."""
        if self.device.type != "cuda":
            dst.copy_(src)
            return None
        dst.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return ev
