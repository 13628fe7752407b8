"""A copy of the benchmark at a size the CPU runs in seconds, for its tests:
the same files with each configuration at 160 px and each serving mix at
batch 2 (1 for one camera) of 320 x 180 frames."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``h100_bench/`` shrunk to
    test size; returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", dest / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (dest / "h100_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["res"] = 160
        path.write_text(json.dumps(cfg))
    for path in (dest / "h100_bench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(batch=min(tr["batch"], 2), frame_wh=[320, 180], pool=2, check_requests=2,
                  warmup_requests=1, trace_warmup=1, trace_requests=2)
        path.write_text(json.dumps(tr))
    return dest
