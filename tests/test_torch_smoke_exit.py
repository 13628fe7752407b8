"""``chip_smoke.py`` ends only after every process it started has.

The script's data loaders start a worker server (multiprocessing's
forkserver) in the script and in each spawned rank, and the server of a
rank outlives its rank. Each case runs a small program that imports the
script's ``adopt_orphans`` and ``stop_children`` as the script's entry does,
tags its environment with a fresh marker, and checks at the moment it has
exited that no process carrying the marker is left.
"""
import json
import os
import subprocess
import sys
import textwrap
import uuid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = textwrap.dedent("""
    import json, subprocess, sys
    sys.path.insert(0, {root!r})
    import chip_smoke
    from detrpose_tpu_torch.data.loader import _pool_context
    from detrpose_tpu_torch.parallel.dist import run_ranks


    def square(x):
        return x * x


    def rank_pools(rank, world):
        pool = _pool_context().Pool(2)
        assert pool.map(square, range(3)) == [0, 1, 4]
        pool.close()
        pool.join()


    if __name__ == "__main__":
        chip_smoke.adopt_orphans()
        try:
            pool = _pool_context().Pool(2)
            assert pool.map(square, range(4)) == [0, 1, 4, 9]
            pool.close()
            pool.join()
            del pool
            run_ranks(rank_pools, 2, (), deadline_s=120)
            if {stuck}:
                subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
            before = chip_smoke.children()
        finally:
            signalled = chip_smoke.stop_children(grace_s=1.0, deadline_s=5.0)
        print(json.dumps({{"before": sorted(before.values()),
                           "signalled": sorted(signalled.values()),
                           "after": len(chip_smoke.children())}}))
""")


def marked(marker):
    """Command lines of the processes whose environment holds ``marker``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() not in f.read():
                    continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                found.append(f.read().replace(b"\0", b" ").decode(errors="replace"))
        except OSError:
            continue
    return found


def run_program(tmp_path, stuck):
    script = tmp_path / "program.py"
    script.write_text(PROGRAM.format(root=ROOT, stuck=stuck))
    marker = f"SMOKE_EXIT_MARKER={uuid.uuid4().hex}"
    key, value = marker.split("=")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, **{key: value}))
    left = marked(marker)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1]), left


def test_worker_servers_of_the_script_and_its_ranks_are_stopped(tmp_path):
    out, left = run_program(tmp_path, stuck=False)
    # the script's worker server and both ranks', adopted (running, or ended
    # and not yet reaped), beside the resource tracker
    servers = [cmd for _, cmd in out["before"] if "multiprocessing.resource_tracker" not in cmd]
    assert len(servers) == 3, out["before"]
    assert out["signalled"] == [] and out["after"] == 0
    assert left == []


def test_a_child_that_does_not_end_is_signalled(tmp_path):
    out, left = run_program(tmp_path, stuck=True)
    assert len(out["signalled"]) == 1 and "time.sleep(600)" in out["signalled"][0]
    assert out["after"] == 0
    assert left == []
