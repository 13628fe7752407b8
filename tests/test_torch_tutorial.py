"""examples/tutorial_torch.py, the port's walkthrough, runs end to end on the
CPU (N, 160 px), as tests/test_tutorial.py runs the JAX one: the image
synthesised from its seed, both latencies printed, the overlay written.
The port's repo-level programs import no JAX."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tutorial_runs_end_to_end(tmp_path):
    out = tmp_path / "overlay.jpg"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "tutorial_torch.py"),
         "--size", "n", "--res", "160", "--device", "cpu", "--thresh", "0.01",
         "--output", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "synthesised from seed 0" in r.stdout
    assert "first call:" in r.stdout and "steady call:" in r.stdout
    assert "on the CPU" in r.stdout
    assert '"msda_fwd": 0' in r.stdout     # the plain version runs on the CPU
    assert out.exists() and out.stat().st_size > 1000


@pytest.mark.parametrize("program", ["examples/tutorial_torch.py", "chip_smoke.py"])
def test_programs_import_no_jax(program):
    """The program, imported in a fresh process, brings in no JAX, nothing of
    the JAX package, bench.py or a tools_local_* module (the package's own
    modules: tests/test_torch_ops.py)."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('program', {program!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'orbax', 'detrpose_tpu', 'bench') or n.startswith('tools_local'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
