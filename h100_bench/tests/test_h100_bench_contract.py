"""``BENCHMARK.json`` against the shape of the benchmark's contract, every
file it names present, and the imports of the benchmark's modules: nothing
of JAX or the JAX package anywhere (top-level names compared whole:
``detrpose_tpu_torch`` is not ``detrpose_tpu``), nothing of the program in
the reference."""
import ast
import json
import re

import pytest

from h100_bench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "detrpose_tpu"}


def test_keys_and_limits_of_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"] and BENCH["command"][1] == "h100_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("h100_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (ROOT / "h100_bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100_bench/limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "h100_bench/metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def _modules():
    return sorted(p for p in (ROOT / "h100_bench").rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_plain_reference(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.relative_to(ROOT / "h100_bench").parts:
        assert "detrpose_tpu_torch" not in tops
    text = path.read_text()
    # no record of the JAX era is read: its bench script and JSON records
    records = ["bench" + r"\.py", "BENCH" + "_r", "MULTICHIP" + "_r", "RACE" + "_r",
               "BASELINE" + r"\."]
    assert not re.search(r"\b(" + "|".join(records) + ")", text)
