"""The readers of the program's own spans on a small recorded trace whose
answers are known: two batches of a serving cell in the profiler's chrome
format, each with the program's ``pipeline.*`` ranges, a pageable upload,
a pageable copy and a memset launched inside ``pipeline.forward`` among its
kernels, idle time inside it, work launched from another host thread, and
the results' copy to the host in ``pipeline.decode``."""
import json
from types import SimpleNamespace

import pytest

from h100_bench.run import ROOT, reader
from h100_bench.trace import Trace

NEW = ("upload_device_ms.serve", "upload_host_ms.serve", "forward_idle_ms.serve",
       "forward_syncs.serve", "forward_launches.serve")
PAGEABLE_UP = "Memcpy HtoD (Pageable -> Device)"
PAGEABLE_DOWN = "Memcpy DtoH (Device -> Pageable)"


def _events(program_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000,
           "tid": 1}]
    ranges = [("bench.request", 10, 490), ("bench.model", 100, 400),
              ("model.backbone", 105, 200), ("model.encoder", 200, 300),
              ("model.transformer", 300, 400)]
    if program_spans:
        ranges += [("pipeline.upload", 10, 90), ("pipeline.preprocess", 90, 100),
                   ("pipeline.forward", 100, 400), ("pipeline.decode", 400, 450),
                   ("detrpose.backbone", 104, 200), ("detrpose.encoder", 200, 300),
                   ("detrpose.transformer", 300, 400)]
    # (host thread, launch, category, name, start, duration)
    work = [(1, 12, "gpu_memcpy", PAGEABLE_UP, 20, 60),          # the frames
            (1, 84, "gpu_memcpy", PAGEABLE_UP, 85, 2),           # their sizes
            (1, 92, "kernel", "uint8_to_float_kernel", 94, 5),
            (1, 110, "kernel", "conv_kernel", 120, 50),
            (2, 150, "kernel", "other_thread_kernel", 180, 10),
            (1, 205, "kernel", "gemm_kernel", 210, 40),
            (1, 260, "gpu_memcpy", PAGEABLE_UP, 262, 1),         # a constant
            (1, 302, "kernel", "void msda_fwd_kernel<__nv_bfloat16, 8>", 310, 20),
            (1, 340, "gpu_memset", "Memset (Device)", 345, 1),
            (1, 410, "kernel", "topk_kernel", 420, 10),
            (1, 435, "gpu_memcpy", PAGEABLE_DOWN, 440, 5)]
    corr = 0
    for off in (0, 500):
        for name, a, b in ranges:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": off + a,
                       "dur": b - a, "tid": 1})
        for tid, launch, cat, name, t, dur in work:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": off + launch, "dur": 1, "tid": tid, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": off + t, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    return ev


def _run(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=Trace.from_file(str(path)), trace_run=True,
                           traffic={"batch": 32})


@pytest.mark.parametrize("name, expected", [
    ("upload_device_ms.serve", 0.062),        # 60 + 2 us of copy a batch
    ("upload_host_ms.serve", 0.080),
    # 300 us of forward less 50 + 10 + 40 + 1 + 20 + 1 us busy (the other
    # thread's kernel keeps the device busy all the same)
    ("forward_idle_ms.serve", 0.178),
    ("forward_syncs.serve", 1.0),             # the upload's and decode's copies are outside
    ("forward_launches.serve", 5.0),          # the other thread's launch is not the forward's
])
def test_reader(tmp_path, name, expected):
    assert reader(ROOT, name).read(_run(tmp_path, _events())) == pytest.approx(expected)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_a_trace_or_the_span(tmp_path, name):
    run = _run(tmp_path, _events(program_spans=False))    # a program that opens no span
    assert reader(ROOT, name).read(run) is None
    run.trace = None
    assert reader(ROOT, name).read(run) is None

