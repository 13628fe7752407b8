"""The readers of gradient energy refinement (``metrics/_energy.py``) and
the bound of kernel #1's backward (``bounds_msda_bwd.py``).

On a small recorded trace whose answers are known: two batches, each with
the program's ``decoder.energy`` span and its three steps on the main
thread, and each step's backward launched from another thread (autograd's,
on the card) inside ``msda_fwd_backward`` ranges opened there; then the
same readers on a traced CPU run of the cell ``l-coco-energy.video-bs32``
shrunk to CPU size, and on traces that lack the spans."""
import json
import math
from types import SimpleNamespace

import pytest

from h100_bench import peaks
from h100_bench.bounds_msda_bwd import (msda_bwd_bound_s, msda_bwd_bytes,
                                        msda_bwd_operations, taps)
from h100_bench.run import ROOT, execute, reader
from h100_bench.tests.tiny import tiny_root
from h100_bench.trace import Trace

CARD = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
CELL = "l-coco-energy.video-bs32"
READERS = ("energy_device_ms.serve", "energy_idle_ms.serve", "energy_launches.serve",
           "msda_bwd_roofline.serve")
CONFIG = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco-energy.json").read_text())
QUERIES = 60 * 18


def _events(energy_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000,
           "tid": 1}]
    # (host thread, name, start, end)
    ranges = [(1, "bench.request", 10, 490), (1, "pipeline.forward", 100, 400)]
    if energy_spans:
        ranges += [(1, "decoder.energy", 250, 390),
                   (1, "energy.step", 250, 290), (1, "energy.step", 295, 340),
                   (1, "energy.step", 345, 390),
                   (1, "energy.grad", 270, 290), (1, "energy.grad", 320, 340),
                   (1, "energy.grad", 370, 390)]
    # kernel #1's backward, on autograd's thread
    ranges += [(2, "msda_fwd_backward", 272, 288), (2, "msda_fwd_backward", 322, 338),
               (2, "msda_fwd_backward", 372, 388)]
    # (host thread, launch, name, start, duration)
    work = [(1, 110, "conv_kernel", 120, 50),                 # before the refinement
            (1, 255, "energy_layer_kernel", 260, 8),          # a step's forward
            (2, 273, "grid_sampler_backward", 275, 6),        # step 1's backward
            (2, 274, "reduce_kernel", 282, 4),
            (1, 284, "main_thread_kernel", 287, 1),           # in no backward range
            (2, 289, "autograd_kernel", 290, 2),              # after its range
            (2, 323, "grid_sampler_backward", 325, 10),       # step 2's
            (2, 373, "grid_sampler_backward", 375, 10),       # step 3's
            (1, 395, "topk_kernel", 400, 5)]                  # after the refinement
    corr = 0
    for off in (0, 500):
        for tid, name, a, b in ranges:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": off + a,
                       "dur": b - a, "tid": tid})
        for tid, launch, name, t, dur in work:
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": off + launch, "dur": 1, "tid": tid, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": off + t, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    return ev


def _run(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=Trace.from_file(str(path)), trace_run=True, config=CONFIG,
                           traffic={"batch": 32}, peaks=CARD)


def test_the_bound_at_the_cells_shapes():
    m = CONFIG["model"]
    bound, by = msda_bwd_bound_s(m, 640, 32, QUERIES, 2, CARD)
    # 32 images x 1080 tokens x 8 heads x 3 levels x 4 points
    assert taps(m, 32, QUERIES) == 3317760
    assert msda_bwd_bytes(m, 640, 32, QUERIES, 2) == 234946560
    assert msda_bwd_operations(m, 32, QUERIES) == 24 * 3317760 * 32
    assert by == "bytes" and bound == pytest.approx(234946560 / 3.35e12)
    assert bound > 0


def test_the_bound_moves_with_the_value_maps_type_alone():
    m = CONFIG["model"]
    half, full = (msda_bwd_bytes(m, 640, 32, QUERIES, vb) for vb in (2, 4))
    # the value map and the output's gradient, which the op gives the value
    # map's type, take the served type; locations, weights and their
    # gradients are float32 whatever it is: 24 bytes a tap
    S = 80 * 80 + 40 * 40 + 20 * 20
    assert full - half == 2 * (32 * S * 256 + 32 * QUERIES * 256)
    assert half - 2 * (32 * S * 256 + 32 * QUERIES * 256) == 24 * taps(m, 32, QUERIES)


@pytest.mark.parametrize("name, expected", [
    # 8 + 6 + 4 + 1 + 2 + 10 + 10 us launched inside decoder.energy, on
    # either thread
    ("energy_device_ms.serve", 0.041),
    # 140 us of decoder.energy less its 41 us busy
    ("energy_idle_ms.serve", 0.099),
    ("energy_launches.serve", 7.0),
    # 6 + 4, 10 and 10 us launched inside the three ranges on their own
    # thread: 10 us a range
    ("msda_bwd_roofline.serve", 100 * 234946560 / 3.35e12 / 10e-6),
])
def test_reader(tmp_path, name, expected):
    assert reader(ROOT, name).read(_run(tmp_path, _events())) == pytest.approx(expected)


@pytest.mark.parametrize("name", READERS[:3])
def test_reader_finds_nothing_without_the_energy_span(tmp_path, name):
    run = _run(tmp_path, _events(energy_spans=False))     # a program that opens none
    assert reader(ROOT, name).read(run) is None
    run.trace = None
    assert reader(ROOT, name).read(run) is None


def test_backward_roofline_finds_nothing_without_its_range_or_work(tmp_path):
    events = [e for e in _events() if e["name"] != "msda_fwd_backward"]
    assert reader(ROOT, READERS[3]).read(_run(tmp_path, events)) is None
    events = [e for e in _events() if e.get("cat") != "kernel"]
    assert reader(ROOT, READERS[3]).read(_run(tmp_path, events)) is None
    run = _run(tmp_path, _events())
    run.trace = None
    assert reader(ROOT, READERS[3]).read(run) is None


@pytest.fixture(scope="module")
def traced_cpu_run(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("energy_readers"))
    return execute(root, CELL, 2**31 + 11, 0.3, True, device="cpu", chips_check=False)


def test_a_traced_cpu_run_of_the_cell(traced_cpu_run):
    r = traced_cpu_run
    assert r["correct"] is True, r["checks"]
    got = r["metrics"]
    # the CPU launches no device work: no time and no launch, the whole
    # refinement idle
    assert got["energy_device_ms.serve"]["value"] == 0.0
    assert got["energy_launches.serve"]["value"] == 0.0
    assert math.isfinite(got["energy_idle_ms.serve"]["value"])
    assert got["energy_idle_ms.serve"]["value"] > 0
    # with no device time to divide by the roofline reads nothing
    assert "msda_bwd_roofline.serve" not in got


def test_the_cell_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "detrpose-l-coco-energy", "video-bs32", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("serve_images_per_s", "mfu.serve", "device_idle_share.serve",
                 "msda_fwd_roofline.serve"):
        assert metrics[name]["workloads"] == ["l-coco.video-bs32", CELL]
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "serve_images_per_s"
    limits = json.loads((ROOT / "h100_bench/limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"enc_score_err", "score_img_rms", "kpt_rms", "decode_mismatch",
                           "energy_kpt_rel"} and limits["decode_mismatch"] == 0
