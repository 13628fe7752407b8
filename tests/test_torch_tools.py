"""The port's benchmark, MSDA-bench and export tools, on the CPU.

``model_info`` counts parameters as the JAX package does (the ``params``
leaves of ``jax.eval_shape(model.init)``), exactly. ``bench_size`` runs at a
tiny size and says that it timed on the host clock. An exported N program
(batch 2, 160 px, float32) is reloaded in a fresh process and matches the
eager serve module within 1e-5 (the same CPU kernels in the same order).
The timing tools need a CUDA device and raise without one.
``card_power_limit`` reads nvidia-smi's name and power limit, and gives
None for what nvidia-smi does not tell.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config

from detrpose_tpu_torch.tools import benchmark, pallas_bench
from detrpose_tpu_torch.tools.export import PROGRAM, build_serve, export_model
from detrpose_tpu_torch.tools.phase_times import main as phase_times_main, range_times
from detrpose_tpu_torch.utils import measure
from detrpose_tpu_torch.utils.measure import card_power_limit, cuda_time_ms

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("size", ["n", "s", "m", "l", "x"])
def test_model_info_params_match_jax(size):
    model = jax_build_model(jax_model_config(size))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    info = benchmark.model_info(size, res=128, device="cpu")
    assert info["params"] == n_jax
    assert info["params_M"] == round(n_jax / 1e6, 2)
    assert info["gflops"] > 0 and info["device"] == "cpu"


def test_bench_size_on_cpu():
    out = benchmark.bench_size("n", 1, res=128, warmup=1, iters=1, device="cpu")
    assert out["basis"] == "cpu_host_clock" and out["device"] == "cpu"
    assert out["latency_ms"] > 0 and out["images_per_sec"] > 0
    assert out["launches"] == {"msda_fwd": 0, "msda_perquery": 0, "msda_colsin": 0,
                               "msda_tpose": 0, "msda_ablate": 0}
    assert {"size", "batch", "res", "bf16", "iters"} <= set(out)


def test_pallas_bench_paths_agree_on_cpu():
    # the three paths the bench times compute one function
    value_levels, loc, aw = pallas_bench.l_inputs(batch=1, res=64, dtype=torch.float32,
                                                  device="cpu")
    assert [tuple(v.shape) for v in value_levels] == [(1, 8, 8, 8, 32), (1, 4, 4, 8, 32),
                                                      (1, 2, 2, 8, 32)]
    outs = [fn(value_levels, loc, aw) for fn in pallas_bench.PATHS.values()]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-6)


def test_export_round_trip(tmp_path):
    out = export_model("n", batch=2, res=160, bf16=False, out_dir=str(tmp_path),
                       device="cpu")
    program = torch.export.load(os.path.join(out, PROGRAM))
    assert "detrpose_tpu_torch.msda_fwd" in str(program.graph)   # the kernel call
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 160, 160)).astype(np.float32))
    ts = torch.tensor([[640.0, 480.0], [333.0, 500.0]])
    torch.save({"x": x, "ts": ts}, tmp_path / "inputs.pt")
    code = (
        "import sys, torch\n"
        "from detrpose_tpu_torch.tools.export import load_exported\n"
        "d = sys.argv[1]\n"
        "ins = torch.load(d + '/inputs.pt')\n"
        "torch.save(list(load_exported(d)(ins['x'], ins['ts'])), d + '/outputs.pt')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(tmp_path / "outputs.pt")
    with torch.no_grad():
        want = build_serve("n", bf16=False, device="cpu")(x, ts)
    assert json.load(open(tmp_path / "meta.json"))["fused"] is True
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_timing_tools_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_time_ms(lambda: None, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pallas_bench.bench(batch=1, res=64, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.bench_size("n", 1, res=128)


H100_LINE = "NVIDIA H100 80GB HBM3, 700.00 W"
NA_LINE = "NVIDIA H100 80GB HBM3, [N/A]"


@pytest.mark.parametrize("answer, want", [
    (H100_LINE, (H100_LINE, 700.0)),
    (OSError("nvidia-smi: not found"), (None, None)),
    (subprocess.TimeoutExpired("nvidia-smi", 60), (None, None)),
    (NA_LINE, (NA_LINE, None)),
], ids=["limit", "no-nvidia-smi", "timeout", "no-limit"])
def test_card_power_limit(monkeypatch, answer, want):
    def run(cmd, **kw):
        assert cmd[0] == "nvidia-smi" and "--query-gpu=name,power.limit" in cmd
        if isinstance(answer, BaseException):
            raise answer
        return subprocess.CompletedProcess(cmd, 0, stdout=answer + "\n", stderr="")

    monkeypatch.setattr(measure.subprocess, "run", run)
    assert card_power_limit() == want


def test_range_times_reads_a_profile():
    """tools/phase_times.py's split of a profiler session by its ranges: the
    host time and calls of each recorded range, no device time without a
    device, a range the session did not record left out; its command line
    refuses to run without a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("phase.a"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    times = range_times(prof, ("phase.a", "phase.absent"))
    assert set(times) == {"phase.a"}
    assert times["phase.a"]["calls"] == 3 and times["phase.a"]["host_ms"] > 0
    assert times["phase.a"]["device_ms"] == 0 and times["phase.a"]["spans"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            phase_times_main([])
