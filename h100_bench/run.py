"""One run of one cell of the benchmark of ``detrpose_tpu_torch``, the
PyTorch and CUDA port, on the CUDA devices of this machine.

  python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. Everything that belongs to one piece of a cell is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

- the configuration: the ``file`` of its entry (``h100_bench/configs/``);
- the traffic mix: ``h100_bench/traffic/<traffic>.json``, whose ``kind``
  names the module of ``h100_bench/kinds/`` that generates and drives it;
- each metric: ``h100_bench/metrics/<name>.py``, a reader of the run's
  record (host clock, or with ``--trace 1`` the profiled window's trace);
- the numbers that decide ``correct`` and their limits:
  ``h100_bench/limits/<cell>.json`` (``h100_bench/judge.py`` computes them).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error.

``--control fp8`` puts the benchmark's float8 control (``control.py``) in
the program's place and prints the numbers it reads; it measures nothing.

The run fails, with no result, where no CUDA device is present, where the
cell asks for more devices than there are, where the card has no entry in
``peaks.py``, where the cell's limits name no limit for a number the run
reads, or where JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
# faults planted under the timed path, to show that the comparison fails them
FAULTS = ("half_batch", "alter_answer", "alter_logit", "skip_energy")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "detrpose_tpu")


def process_start() -> float:
    """The epoch time at which this process started (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def forbidden_modules() -> List[str]:
    """Top-level names of the loaded modules that the run may not hold,
    compared whole: ``detrpose_tpu_torch`` is not ``detrpose_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_cell(root: Path, workload: str):
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "h100_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, workload: str, per_layer: bool) -> List[dict]:
    """The metrics this cell reports: end-to-end ones, or per-layer ones,
    whose ``workloads`` list it (or that have no such list)."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def reader(root: Path, name: str):
    """The module ``h100_bench/metrics/<name>.py``."""
    path = root / "h100_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a kind's ``run`` is given: the cell's files, the run's
    arguments, the device, and the calls that mark the run's phases."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device, control, fault):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.control, self.fault = device, control, fault
        self.setup_s: Optional[float] = None

    def note(self, phase: str) -> None:
        """Print how far into the process ``phase`` ended (standard error)."""
        print(f"h100_bench: {phase} at {time.time() - T_START:.3f} s", file=sys.stderr)

    def setup_done(self) -> None:
        """Set-up ends here: the next thing is the first timed item."""
        self.setup_s = time.time() - T_START
        self.note("set-up")

    def memory_peak(self) -> int:
        import torch
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" \
            else 0

    def window_closed(self) -> None:
        """JAX or the JAX package loaded by now ends the run."""
        found = forbidden_modules()
        if found:
            print(f"h100_bench: loaded after the window: {found}", file=sys.stderr)
            raise SystemExit(3)

    def free(self) -> None:
        """Let go of the program's memory before the reference runs."""
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e30


def execute(root: Path, workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", control: Optional[str] = None, chips_check: bool = True,
            fault: Optional[str] = None) -> dict:
    """One run; returns the result object (``checks`` last). ``device``
    "cpu" with ``chips_check`` False drives the same run on the CPU, for
    the benchmark's own tests: no number it gives is a device number."""
    import torch

    from h100_bench import peaks

    bench, cell, config, traffic = load_cell(root, workload)
    if chips_check:
        if not torch.cuda.is_available():
            raise SystemExit("h100_bench: no CUDA device; the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"h100_bench: {workload} needs {cell['chips']} CUDA devices, "
                             f"this machine has {torch.cuda.device_count()}")
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    card_peaks = peaks.peak(name) if dev.type == "cuda" else peaks.PEAKS[next(iter(peaks.PEAKS))]
    kind = importlib.import_module(f"h100_bench.kinds.{traffic['kind']}")
    ctx = Context(cell, config, traffic, seed, seconds, trace, dev, control, fault)
    rec = kind.run(ctx)

    limits_path = root / "h100_bench" / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    unnamed = sorted(set(rec["checks"]) - set(limits))
    if unnamed:     # a number the run reads is always compared
        raise SystemExit(f"h100_bench: {workload}: h100_bench/limits/{workload}.json names "
                         f"no limit for {unnamed}")
    # the numbers compared are those the cell's limits name; one the run
    # did not give reads as infinite
    checks = {k: {"value": _finite(rec["checks"].get(k, math.inf)), "limit": lim}
              for k, lim in limits.items()}
    correct = (bool(checks) and rec["attempted"] > 0 and rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    run = SimpleNamespace(**rec, cell=cell, config=config, traffic=traffic, peaks=card_peaks,
                          setup_s=ctx.setup_s, trace_run=trace)
    metrics = {}
    if not control:
        for m in cell_metrics(bench, workload, per_layer=trace):
            value = reader(root, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                         "count": cell["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}}
    tr = rec.get("trace")
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = tr.breakdown()
    lat = sorted(rec["latencies"])
    result["info"] = {"window_s": rec["window_s"], "requests": rec["attempted"],
                      "selection": rec.get("selection", {}),
                      **({f"latency_p{q}_ms": 1e3 * lat[len(lat) * q // 100]
                          for q in (5, 25, 50, 75)} if lat else {})}
    result["checks"] = checks
    return result


def main(argv=None, root: Path = ROOT, device: str = "cuda", chips_check: bool = True) -> int:
    """The command line; ``root``, ``device`` and ``chips_check`` let the
    benchmark's own tests drive a run on the CPU (see ``execute``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(cache / sub))
    # one process with few threads: the host work of the window is the
    # program's dispatch, which a busy thread pool beside it only disturbs
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # run as a script, this folder heads the path: its modules (trace.py,
    # ...) would shadow the standard library's; the checkout's root goes there
    if sys.path and Path(sys.path[0]).resolve() == BENCH_DIR:
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result = execute(root, args.workload, args.seed, args.seconds, bool(args.trace),
                     device=device, control=args.control, chips_check=chips_check,
                     fault=args.fault)
    info = result.pop("info")
    print(json.dumps({"info": info}), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
