"""bench_torch.py, the port's headline bench (the counterpart of bench.py),
on the CPU with small counts (N, bs 1, 160 px, 2 calls after 1 warm-up, a
64^3 control; the card's peak stubbed by name).

Its one JSON line carries every field of bench.py's line that has a meaning
on the card, with its type and the metric's name; a stub peak below the
implied rate trips bench.py's gate (``measurement_invalid``, no
``vs_baseline``); a stubbed timing gives the MFU by its arithmetic; the
forward calls each launch kernel #1's count (none on the CPU: the wrapper
takes the plain version for a CPU tensor).
"""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from detrpose_tpu_torch.utils import measure  # noqa: E402
from detrpose_tpu_torch.utils.measure import TRT_L_IPS, throughput_fields  # noqa: E402

FIELDS = {
    "metric": str, "value": float, "unit": str, "vs_baseline": (float, type(None)),
    "measurement_basis": str, "measurement_invalid": bool, "ms_per_batch": float,
    "gflops_per_batch": float, "flops_counted": str, "implied_tflops_per_sec": float,
    "device_kind": str, "device_peak_tflops_bf16": (float, type(None)),
    "power_limit_w": (float, type(None)), "mfu": (float, type(None)),
    "control_matmul_tflops": float, "control_matmul_tflops_end": float,
    "dispatch_wall_ms_per_batch": float, "serving_ips_host_to_device": float,
    "serving_vs_baseline": float, "serving_overlap_ratio": float,
    "h2d_sustained_mbps": float, "h2d_effective_mbps_in_loop": float,
    "forward_calls": int, "launches": dict,
}


@pytest.fixture
def small(monkeypatch):
    for k, v in (("BENCH_MODEL", "n"), ("BENCH_BATCH", "1"), ("BENCH_RES", "160"),
                 ("BENCH_ITERS", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench_torch, "WARMUP", 1)
    monkeypatch.setattr(bench_torch, "matmul_control_tflops",
                        lambda dev, dim: measure.matmul_control_tflops(dev, 64))


def _peak(monkeypatch, tflops):
    """The CPU given a bf16 peak by name, as the card is (None: no peak)."""
    monkeypatch.setattr(bench_torch, "DEVICE_PEAK_TFLOPS",
                        {} if tflops is None else {"cpu": tflops})


def _run(capsys):
    result = bench_torch.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    return result


def test_fields_and_gate(small, capsys, monkeypatch):
    _peak(monkeypatch, 1e-9)
    r = _run(capsys)
    assert r.keys() == FIELDS.keys()
    for k, t in FIELDS.items():
        assert isinstance(r[k], t), (k, r[k])
    assert r["metric"] == "detrpose_n_bs1_160px_images_per_sec_per_chip"
    assert r["unit"] == "images/sec" and r["device_kind"] == "cpu"
    assert "host clock" in r["measurement_basis"] and "CPU" in r["measurement_basis"]
    assert r["gflops_per_batch"] > 0 and r["forward_calls"] > 2
    # the stub peak lies below the implied rate: bench.py's gate
    assert r["measurement_invalid"] is True and r["vs_baseline"] is None
    assert set(r["launches"]) >= {"msda_fwd"} and not any(r["launches"].values())


def test_mfu_on_a_stubbed_timing(small, capsys, monkeypatch):
    # 4 us a batch: hundreds of TFLOP/s from N's few GFLOPs, so the printed
    # rate's rounding (0.1 TFLOP/s) stays far below the MFU's tolerance; the
    # printed GFLOPs are rounded to 0.1 of ~3.4
    monkeypatch.setattr(bench_torch, "carried_time_ms", lambda *a, **k: 0.004)
    _peak(monkeypatch, 1000.0)
    r = _run(capsys)
    assert r["ms_per_batch"] == 0.004 and r["value"] == 250000.0
    assert r["implied_tflops_per_sec"] == pytest.approx(r["gflops_per_batch"] / 0.004,
                                                        rel=2e-2)
    assert r["mfu"] == pytest.approx(r["implied_tflops_per_sec"] / 1000.0, rel=1e-3)
    assert r["measurement_invalid"] is False
    assert r["vs_baseline"] == round(250000.0 / TRT_L_IPS, 3)
    # no peak for the device: no MFU, and the gate cannot trip
    _peak(monkeypatch, None)
    assert _run(capsys)["mfu"] is None


def test_throughput_arithmetic():
    f = throughput_fields(50.0, 3.5e12, 32, 989.0)
    assert f["images_per_sec"] == pytest.approx(640.0)
    assert f["implied_tflops_per_sec"] == pytest.approx(70.0)
    assert f["mfu"] == pytest.approx(70.0 / 989.0)
    assert f["vs_baseline"] == pytest.approx(640.0 / TRT_L_IPS)
    assert not f["measurement_invalid"]
    g = throughput_fields(50.0, 3.5e12, 32, 50.0)
    assert g["measurement_invalid"] and g["vs_baseline"] is None
    assert throughput_fields(50.0, None, 32, 989.0)["mfu"] is None


def test_programs_import_no_jax():
    """bench_torch.py and examples/tutorial_torch.py, imported in a fresh
    process, bring in no JAX, nothing of the JAX package, bench.py or a
    tools_local_* module (the package's own modules: tests/test_torch_ops.py)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib.util, sys\n"
        "import bench_torch\n"
        "spec = importlib.util.spec_from_file_location('tutorial_torch', "
        "'examples/tutorial_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'orbax', 'detrpose_tpu', 'bench') or n.startswith('tools_local'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
