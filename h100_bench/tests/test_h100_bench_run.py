"""Whole runs of the benchmark's cells, shrunk to CPU size (``tiny.py``):
the result line and the compared numbers, the planted faults and the
float8 control each turning ``correct`` false, a configuration, a traffic
mix, a metric and a cell added as new files and found, and the clean
failures where no CUDA device or no program is present."""
import json
import os
import subprocess
import sys

import pytest

from h100_bench import peaks
from h100_bench.run import ROOT, execute, forbidden_modules, main
from h100_bench.tests.tiny import tiny_root

SEED = 2**31 + 5
CELLS = ("l-coco.video-bs32",)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, capsys, cell, trace):
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)]
    assert main(argv, root=tiny, device="cpu", chips_check=False) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want and (trace or set(line["metrics"]) == want)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    limits = json.loads((tiny / "h100_bench/limits" / f"{cell}.json").read_text())
    assert {k: c["limit"] for k, c in line["checks"].items()} == limits
    tail = err.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["alter_answer", "half_batch", "alter_logit"])
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    r = execute(tiny, cell, SEED, 0.3, False, device="cpu", chips_check=False, fault=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(tiny, cell):
    r = execute(tiny, cell, SEED, 0.3, False, device="cpu", chips_check=False, control="fp8")
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_new_files_are_found(tiny, tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries alone, in a copy, with no file of the benchmark edited."""
    root = tiny_root(tmp_path)
    h = root / "h100_bench"
    cfg = json.loads((h / "configs/detrpose-l-coco.json").read_text())
    cfg["name"] = "detrpose-l-crowdpose"
    cfg["model"]["num_body_points"] = 14
    (h / "configs/detrpose-l-crowdpose.json").write_text(json.dumps(cfg))
    mix = json.loads((h / "traffic/video-bs32.json").read_text())
    mix.update(batch=1, pool=1, check_requests=1)
    (h / "traffic/stream-one-frame.json").write_text(json.dumps(mix))
    (h / "metrics/requests_done.py").write_text(
        "def read(run):\n    return None if run.trace_run else float(run.attempted)\n")
    (h / "limits/l-crowdpose.one-frame.json").write_text(
        (h / "limits/l-coco.video-bs32.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "detrpose-l-crowdpose", "source": "https://arxiv.org/abs/2506.13027",
                             "file": "h100_bench/configs/detrpose-l-crowdpose.json",
                             "reduced": [], "why": "14 keypoints"})
    bench["workloads"].append({"name": "l-crowdpose.one-frame", "config": "detrpose-l-crowdpose",
                               "traffic": "stream-one-frame", "chips": 1, "why": "one frame"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["l-crowdpose.one-frame"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); from pathlib import Path; "
            "from h100_bench.run import main; "
            f"main(['--workload', 'l-crowdpose.one-frame', '--seed', '3', '--seconds', '0.3'], "
            f"root=Path({str(root)!r}), device='cpu', chips_check=False)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metrics"]["requests_done"]["value"] >= 1
    assert set(line["metrics"]) == {"requests_done", "setup_s"}


def test_no_cuda_device_fails_cleanly():
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and '"correct"' not in proc.stdout


def test_without_the_program_it_fails(tmp_path):
    root = tiny_root(tmp_path)           # BENCHMARK.json and h100_bench/ only
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=root, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and '"correct"' not in proc.stdout


def test_unknown_card_has_no_peak():
    with pytest.raises(LookupError):
        peaks.peak("NVIDIA A100-SXM4-80GB")


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "detrpose_tpu" not in forbidden_modules() or "detrpose_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "detrpose_tpu_torch_fake", object())
    assert "detrpose_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in forbidden_modules()
