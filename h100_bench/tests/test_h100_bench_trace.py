"""The trace readers of the benchmark on a small recorded trace whose
answers are known: two requests of a serving cell in the profiler's chrome
format, each with its upload, one kernel in each of the backbone, the
encoder and the transformer (kernel #1), a decode kernel and the copy of
the results to the host."""
import json
from types import SimpleNamespace

import pytest

from h100_bench import bounds, peaks
from h100_bench.run import ROOT, reader
from h100_bench.trace import Trace

CARD = peaks.PEAKS["NVIDIA H100 80GB HBM3"]


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000,
           "tid": 1}]
    corr = 0
    for off in (0, 500):
        for name, a, b in (("bench.request", 10, 490), ("bench.model", 100, 400),
                           ("model.backbone", 110, 200), ("model.encoder", 200, 300),
                           ("model.transformer", 300, 400)):
            ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": off + a,
                       "dur": b - a, "tid": 1})
        for cat, name, t, dur in (("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 60),
                                  ("kernel", "conv_kernel", 120, 50),
                                  ("kernel", "gemm_kernel", 210, 40),
                                  ("kernel", "void msda_fwd_kernel<__nv_bfloat16, 8>", 310, 20),
                                  ("kernel", "topk_kernel", 420, 10),
                                  ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 440, 5)):
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": off + t - 2, "dur": 1, "tid": 1, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": off + t, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    return ev


@pytest.fixture
def run(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    config = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco.json").read_text())
    return SimpleNamespace(trace=Trace.from_file(str(path)), trace_run=True, config=config,
                           traffic={"batch": 32}, peaks=CARD, images=64,
                           flops_per_image=1e9, latencies=[0.48e-3, 0.48e-3], window_s=1e-3)


def test_window_busy_and_breakdown(run):
    tr = run.trace
    assert tr.window_s() == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(2 * 185e-6)
    assert tr.count("bench.request") == 2
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(120e-6)]
    assert len(bd["device_ops"]) == 6
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(1e-3 - 2 * 185e-6)


@pytest.mark.parametrize("name, expected", [
    ("pipeline_device_ms.serve", 0.075),          # upload, decode, results
    ("backbone_device_ms.serve", 0.050),
    ("encoder_device_ms.serve", 0.040),
    ("decoder_device_ms.serve", 0.020),
    ("device_idle_share.serve", 63.0),
    ("mfu.serve", 100 * 1e9 * 64 / 1e-3 / 989e12),
])
def test_reader(run, name, expected):
    assert reader(ROOT, name).read(run) == pytest.approx(expected)


def test_msda_roofline_reader(run):
    m = run.config["model"]
    bound, by = bounds.msda_fwd_bound_s(m, 640, 32, 60 * 18, 2, CARD)
    assert by == "bytes" and bound == pytest.approx(5.8249e-5, rel=1e-4)
    got = reader(ROOT, "msda_fwd_roofline.serve").read(run)
    assert got == pytest.approx(100 * bound / 20e-6)


def test_readers_find_nothing_without_a_trace(run):
    run.trace = None
    for name in ("pipeline_device_ms.serve", "msda_fwd_roofline.serve", "mfu.serve",
                 "device_idle_share.serve"):
        assert reader(ROOT, name).read(run) is None


def test_host_clock_readers(run):
    run.trace_run, run.setup_s = False, 12.5
    run.latencies = [0.010] * 94 + [0.020] * 5 + [float("inf")]
    assert reader(ROOT, "serve_images_per_s").read(run) == pytest.approx(99 * 32 / 1e-3)
    assert reader(ROOT, "setup_s").read(run) == 12.5
