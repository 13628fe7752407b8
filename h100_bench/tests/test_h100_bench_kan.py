"""The cell ``l-coco-kan.video-bs32`` (DETRPose-L with the FastKAN decoder
FFN), the bound of its KAN FFN (``bounds_kan.py``) and the readers of the
program's span ``decoder.kan`` (``metrics/_kan.py``).

In a copy shrunk to CPU size (``tiny.py``) sound runs of the cell are
correct under its own limits, and the float8 control and the planted
decoder-logit fault are not. On a small recorded trace whose answers are
known (two batches, each with three ``decoder.kan`` spans, work launched
inside and outside them and from another thread) the readers give the
right sums, and None on a trace without the span."""
import json
from types import SimpleNamespace

import pytest

from h100_bench import bounds, peaks
from h100_bench.bounds_kan import kan_bound_s, kan_operations_per_token, kan_weights
from h100_bench.run import ROOT, execute, reader
from h100_bench.tests.tiny import tiny_root
from h100_bench.trace import Trace

CARD = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
CELL = "l-coco-kan.video-bs32"
READERS = ("kan_device_ms.serve", "kan_launches.serve", "kan_roofline.serve")
CONFIG = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco-kan.json").read_text())
LIMITS = json.loads((ROOT / "h100_bench/limits" / f"{CELL}.json").read_text())
QUERIES = 60 * 18
LAYER = "KAN FFN: models/layers.py FastKANLayer, models/decoder.py"


@pytest.fixture(scope="module")
def kan_root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("kan"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_cell_runs_correct(kan_root, seed):
    r = execute(kan_root, CELL, seed, 0.3, False, device="cpu", chips_check=False)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(LIMITS)


@pytest.mark.parametrize("how", [{"control": "fp8"}, {"fault": "alter_logit"}])
def test_control_and_fault_fail(kan_root, how):
    r = execute(kan_root, CELL, 0, 0.3, False, device="cpu", chips_check=False, **how)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), r["checks"]


def test_the_bound_at_the_cells_shapes():
    m = CONFIG["model"]
    # 2 x (768 x 129 + 129 x 1024 + 3072 x 513 + 513 x 1024 + 1024 x 256)
    assert kan_operations_per_token(m) == 5189120
    # each KAN layer's LayerNorm, coeffs and out_linear, the layer's out_linear
    assert kan_weights(m) == 2599424
    bound, by = kan_bound_s(m, 640, 32, QUERIES, 2, CARD)
    # 6 layers x 32 images x 1080 tokens x 5189120: 1,076.0 GFLOP at 989 TFLOP/s
    assert by == "operations" and bound == pytest.approx(1076015923200 / 989e12)
    assert round(bound * 1e3, 2) == 1.09
    # the bytes, the FFN's input and output in bf16 and its weights once, are
    # far below: 6 x (2 x 34560 x 256 + 2599424) x 2 bytes at 3.35 TB/s
    t_bytes = 6 * (2 * 32 * QUERIES * 256 + 2599424) * 2 / 3.35e12
    assert t_bytes < bound / 10


def test_operations_follow_the_block():
    plain = {k: v for k, v in CONFIG["model"].items() if k not in ("use_kan", "kan_grid")}
    assert round(bounds.serve_flops_per_image(plain, 640, 1) / 1e9, 2) == 109.62
    # less the MLP's 2 x 2 x 256 x 1024 a token, plus the KAN FFN's 5189120,
    # over 1080 tokens and 6 layers
    kan = bounds.serve_flops_per_image(CONFIG["model"], 640, 1)
    assert round(kan / 1e9, 2) == 136.45


def _events(kan_spans=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000,
           "tid": 1}]
    # (host thread, name, start, end)
    ranges = [(1, "bench.request", 10, 490), (1, "pipeline.forward", 100, 400)]
    if kan_spans:
        ranges += [(1, "decoder.kan", 200, 220), (1, "decoder.kan", 250, 270),
                   (1, "decoder.kan", 300, 320)]
    # (host thread, launch, name, start, duration)
    work = [(1, 110, "conv_kernel", 120, 50),                 # before the decoder
            (1, 205, "layer_norm_kernel", 210, 2),            # layer 1's FFN
            (1, 210, "sm80_xmma_gemm_f32f32", 215, 20),
            (2, 212, "other_thread_kernel", 240, 5),          # not its thread
            (1, 230, "cross_attn_kernel", 240, 4),            # between two FFNs
            (1, 255, "sm80_xmma_gemm_f32f32", 260, 20),       # layer 2's
            (1, 305, "sm80_xmma_gemm_f32f32", 310, 20),       # layer 3's
            (1, 315, "exp_kernel", 335, 3),
            (1, 395, "topk_kernel", 400, 5)]                  # after the decoder
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


@pytest.mark.parametrize("name, expected", [
    # 2 + 20 + 20 + 20 + 3 us launched inside decoder.kan on its thread, a batch
    ("kan_device_ms.serve", 0.065),
    ("kan_launches.serve", 5.0),
    ("kan_roofline.serve", 100 * kan_bound_s(CONFIG["model"], 640, 32, QUERIES, 2, CARD)[0]
     / 65e-6),
])
def test_reader(tmp_path, name, expected):
    assert reader(ROOT, name).read(_run(tmp_path, _events())) == pytest.approx(expected)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_the_kan_span(tmp_path, name):
    run = _run(tmp_path, _events(kan_spans=False))     # a program that opens none
    assert reader(ROOT, name).read(run) is None
    run.trace = None
    assert reader(ROOT, name).read(run) is None


def test_a_traced_cpu_run_of_the_cell(kan_root):
    r = execute(kan_root, CELL, 2**31 + 13, 0.3, True, device="cpu", chips_check=False)
    assert r["correct"] is True, r["checks"]
    got = r["metrics"]
    # the CPU launches no device work: no time and no launch inside the span
    assert got["kan_device_ms.serve"]["value"] == 0.0
    assert got["kan_launches.serve"]["value"] == 0.0
    # with no device time to divide by the roofline reads nothing
    assert "kan_roofline.serve" not in got


def test_the_cell_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "detrpose-l-coco-kan", "video-bs32", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("serve_images_per_s", "mfu.serve", "device_idle_share.serve",
                 "decoder_device_ms.serve", "msda_fwd_roofline.serve",
                 "forward_graph_replays.serve"):
        assert metrics[name]["workloads"][-1] == CELL
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL]
        assert metrics[name]["moves"] == "serve_images_per_s"
        assert metrics[name]["layer"] == LAYER
    assert set(LIMITS) == {"enc_score_err", "score_img_rms", "kpt_rms", "decode_mismatch"}
    assert LIMITS["decode_mismatch"] == 0
    assert CONFIG["reduced"] == [] and CONFIG["model"]["use_kan"] is True
    assert CONFIG["model"]["kan_grid"] == 3
