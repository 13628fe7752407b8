"""examples/tutorial_torch.py, the port's walkthrough, runs end to end on the
CPU (N, 160 px), as tests/test_tutorial.py runs the JAX one: the image
synthesised from its seed, both latencies printed, the overlay written."""
import os
import subprocess
import sys

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
