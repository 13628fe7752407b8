"""The reader ``upload_pageable_copies.serve`` on small recorded traces in
the profiler's chrome format: two batches, each with the program's
``pipeline.upload`` and ``pipeline.forward`` ranges, the frames' and sizes'
copies launched inside the upload from pageable or from pinned memory, a
pageable copy launched inside the forward and one launched from another
host thread while the upload is open."""
import json
from types import SimpleNamespace

import pytest

from h100_bench.run import ROOT, reader
from h100_bench.trace import Trace

NAME = "upload_pageable_copies.serve"
PAGEABLE = "Memcpy HtoD (Pageable -> Device)"
PINNED = "Memcpy HtoD (Pinned -> Device)"


def _events(upload_copy, program_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000,
           "tid": 1}]
    ranges = [("pipeline.upload", 10, 90), ("pipeline.forward", 100, 400)] if program_spans else []
    # (host thread, launch, name, start, duration)
    copies = [(1, 20, upload_copy, 30, 20),          # a chunk of the frames
              (1, 40, upload_copy, 50, 20),          # another
              (1, 85, upload_copy, 88, 1),           # the sizes
              (2, 60, PAGEABLE, 70, 5),              # another thread's, while the upload is open
              (1, 260, PAGEABLE, 262, 1)]            # a constant in the forward
    if upload_copy == PAGEABLE:
        copies = [c for c in copies if c[1] != 40]   # the frames in one copy
    corr = 0
    for off in (0, 500):
        for name, a, b in ranges:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": off + a,
                       "dur": b - a, "tid": 1})
        for tid, launch, name, t, dur in copies:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                       "ts": off + launch, "dur": 1, "tid": tid, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "gpu_memcpy", "name": name, "ts": off + t, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    return ev


def _run(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=Trace.from_file(str(path)), trace_run=True,
                           traffic={"batch": 32})


@pytest.mark.parametrize("upload_copy, expected", [(PAGEABLE, 2.0), (PINNED, 0.0)])
def test_counts_the_uploads_pageable_copies(tmp_path, upload_copy, expected):
    assert reader(ROOT, NAME).read(_run(tmp_path, _events(upload_copy))) == expected


def test_finds_nothing_without_a_trace_or_the_span(tmp_path):
    run = _run(tmp_path, _events(PAGEABLE, program_spans=False))
    assert reader(ROOT, NAME).read(run) is None
    run.trace = None
    assert reader(ROOT, NAME).read(run) is None
