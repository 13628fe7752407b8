"""The serving entry's staged upload (``utils/staging.py::StagedUpload``).

On the CPU: the arena's chunking, the workers' copies into it and the guard
on its reuse, with each copy out of the arena held back until something
waits on its event, as an asynchronous copy the device has not run yet; every
request comes out byte for byte ``torch.as_tensor`` of its input. The tests
marked ``gpu`` run ``Pipeline`` on the card against the plain pageable copy
and skip without a CUDA device. The file imports no JAX:

  python -m pytest --noconftest -m gpu tests/test_torch_upload.py
"""
import threading

import numpy as np
import pytest
import torch

from detrpose_tpu_torch.utils import staging
from detrpose_tpu_torch.utils.staging import StagedUpload, chunks, copy_workers


class Late:
    """A copy made only when its event is waited on."""

    def __init__(self, dst: torch.Tensor, src: torch.Tensor):
        self.dst, self.src, self.done, self.lock = dst, src, False, threading.Lock()

    def synchronize(self) -> None:
        with self.lock:
            if not self.done:
                self.dst.copy_(self.src)
                self.done = True

    def query(self) -> bool:
        return self.done


class LateUpload(StagedUpload):
    """``StagedUpload`` on the CPU with every copy out of the arena late."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.workers, self.late = 3, []

    def _send(self, dst, src):
        self.late.append(Late(dst, src))
        return self.late[-1]

    def drain(self) -> None:
        for ev in self.late:
            ev.synchronize()


def _frames(seed: int, n: int, h: int = 8, w: int = 10) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _sizes(x) -> np.ndarray:
    return np.float32([10, 8]) if x.ndim == 3 else np.tile(np.float32([10, 8]), (len(x), 1))


# each case: requests sent back to back; the last is the one named
CASES = {
    "batch_of_uneven_chunks": [_frames(1, 8), _frames(2, 7)],
    "one_image": [_frames(1, 8), _frames(3, 1)[0]],
    "strided_view": [_frames(1, 8), _frames(4, 7)[:, :, ::-1]],
    "torch_tensor": [_frames(1, 8), torch.from_numpy(_frames(5, 7))],
    "larger_than_the_arena": [_frames(1, 2), _frames(6, 7)],
    # the first request's copies past the second's bytes are still to wait for
    "after_a_smaller_one": [_frames(1, 8), _frames(3, 1)[0], _frames(7, 8)],
}


@pytest.mark.parametrize("case", CASES)
def test_staged_request_is_its_input_byte_for_byte(case, monkeypatch):
    """Requests back to back, nothing copied out of the arena until the
    end: each arrives whole, none overwritten by a later one."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", 500)      # 240-byte frames: chunks of 1-2
    up = LateUpload()
    sizes = []
    out = []
    for x in CASES[case]:
        sizes.append(up._arena.numel())
        out.append(up(x, _sizes(x)))
    up.drain()
    for x, (img, wh) in zip(CASES[case], out):
        want = torch.as_tensor(np.ascontiguousarray(x))
        assert img.shape == want.shape and img.dtype == torch.uint8
        assert torch.equal(img, want)
        assert torch.equal(wh, torch.as_tensor(_sizes(x)))
    assert (up._arena.numel() > sizes[-1]) == (case == "larger_than_the_arena")
    assert up._pool is not None and all(ev.done for ev in up.late)


@pytest.mark.parametrize("n, frame_bytes, workers, want", [
    (32, 1280 * 720 * 3, 4, 8),      # the video cell: 8 chunks of 4 frames, 11 MB each
    (1, 1280 * 720 * 3, 4, 1),       # one frame, as the command line sends
    (7, 240, 3, 1),                  # below one chunk's size
    (32, 1280 * 720 * 3, 1, 6),      # one worker: about 16 MiB a chunk
    (3, 64 << 20, 4, 3),             # at most one chunk a frame
])
def test_chunks_cover_the_batch_in_whole_frames(n, frame_bytes, workers, want):
    spans = chunks(n, frame_bytes, workers)
    assert len(spans) == want
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans) and all(p[1] == q[0] for p, q in zip(spans, spans[1:]))
    assert max(b - a for a, b in spans) - min(b - a for a, b in spans) <= 1
    assert 1 <= copy_workers() <= 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory and asynchronous copies)")
    return torch.device("cuda")


@pytest.fixture
def served(cuda):
    """(the staged pipeline, one with the plain pageable upload, two
    different batches of 1280x720 frames and their sizes)."""
    from detrpose_tpu_torch.tools.infer import Pipeline, build_pipeline

    pipe = build_pipeline("n", res=320, device=cuda, generator=torch.Generator().manual_seed(0))
    plain = Pipeline(pipe.model, pipe.res, pipe.num_body_points, pipe.dtype, cuda)
    plain.staging = None
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (8, 720, 1280, 3), dtype=np.uint8) for _ in range(2)]
    return pipe, plain, frames, np.tile(np.float32([1280, 720]), (8, 1))


def _host(out):
    return [t.cpu() for t in out]


@pytest.mark.gpu
def test_staged_pipeline_matches_the_pageable_copy(served):
    pipe, plain, frames, wh = served
    img, wh_d = pipe.upload(frames[0], wh)
    assert torch.equal(img.cpu(), torch.as_tensor(frames[0]))
    assert torch.equal(wh_d.cpu(), torch.as_tensor(wh))
    for got, want in zip(_host(pipe(frames[0], wh)), _host(plain(frames[0], wh))):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_staged_upload_copies_from_pinned_memory(served):
    from torch.profiler import ProfilerActivity, profile

    pipe, _, frames, wh = served
    pipe.upload(frames[0], wh)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.upload(frames[0], wh)
        torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if e.name.startswith("Memcpy HtoD")]
    assert len(copies) == len(chunks(8, frames[0][0].nbytes, pipe.staging.workers)) + 1
    assert not [n for n in copies if "Pageable" in n], copies


@pytest.mark.gpu
def test_back_to_back_calls_wait_for_the_arena(served):
    """The first call's copies queue behind a second of device work, so the
    second call's workers reach the arena while they are still to run."""
    pipe, _, frames, wh = served
    alone = [_host(pipe(f, wh)) for f in frames]
    torch.cuda._sleep(2_000_000_000)
    both = [pipe(f, wh) for f in frames]
    for got, want in zip(both, alone):
        for g, w in zip(_host(got), want):
            assert torch.equal(g, w)
