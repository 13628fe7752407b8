"""A configuration with the port's gradient energy refinement (DETRPose-L,
3 steps of 0.1) and its cell, added to a copy shrunk to CPU size
(``tiny.py``): sound runs are correct, the float8 control and a program
that skips the refinement fail ``energy_kpt_rel``, a key of the ``model``
block that either side cannot build ends the run naming it, so does a
refinement cell whose limits leave ``energy_kpt_rel`` out, and the
operation count follows the block through the refinement's gradient."""
import json

import pytest

from h100_bench import bounds
from h100_bench.kinds import serve_closed
from h100_bench.run import ROOT, execute
from h100_bench.tests.tiny import tiny_root

CELL = "l-coco-energy.video-bs32"
ENERGY = dict(use_energy_refinement=True, grad_energy=True, energy_steps=3,
              energy_step_size=0.1)
# between sound runs (0.054-0.065) and the float8 control (0.44-0.55) at
# this size on the CPU
LIMIT = 0.2


def add_energy_cell(root, limit=LIMIT, drop=(), **model):
    """``root`` with the energy configuration, its limits and its cell
    added as files and entries; ``model`` adds keys to its block, ``drop``
    takes keys out of it; ``limit`` None leaves ``energy_kpt_rel`` out of
    the limits."""
    h = root / "h100_bench"
    cfg = json.loads((h / "configs/detrpose-l-coco.json").read_text())
    cfg["name"] = "detrpose-l-coco-energy"
    cfg["model"].update(ENERGY, **model)
    for k in drop:
        del cfg["model"][k]
    (h / "configs/detrpose-l-coco-energy.json").write_text(json.dumps(cfg))
    limits = json.loads((h / "limits/l-coco.video-bs32.json").read_text())
    if limit is not None:
        limits["energy_kpt_rel"] = limit
    (h / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": cfg["name"],
                             "file": "h100_bench/configs/detrpose-l-coco-energy.json"})
    bench["workloads"].append({**bench["workloads"][0], "name": CELL, "config": cfg["name"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def energy_root(tmp_path_factory):
    return add_energy_cell(tiny_root(tmp_path_factory.mktemp("energy")))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refinement_runs_correct(energy_root, seed):
    r = execute(energy_root, CELL, seed, 0.3, False, device="cpu", chips_check=False)
    assert r["correct"] is True, r["checks"]
    assert 0 < r["checks"]["energy_kpt_rel"]["value"] <= LIMIT


@pytest.mark.parametrize("how", [{"control": "fp8"}, {"fault": "skip_energy"}])
def test_control_and_skipped_refinement_fail_energy_kpt_rel(energy_root, how):
    r = execute(energy_root, CELL, 0, 0.3, False, device="cpu", chips_check=False, **how)
    assert r["correct"] is False
    assert r["checks"]["energy_kpt_rel"]["value"] > LIMIT


def test_skip_energy_is_refused_without_refinement(energy_root):
    with pytest.raises(SystemExit, match="no energy refinement"):
        execute(energy_root, "l-coco.video-bs32", 0, 0.3, False, device="cpu",
                chips_check=False, fault="skip_energy")


def test_a_key_the_reference_does_not_read_ends_the_run(tmp_path):
    root = add_energy_cell(tiny_root(tmp_path), bogus_key=1)
    with pytest.raises(SystemExit, match="bogus_key"):
        execute(root, CELL, 0, 0.3, False, device="cpu", chips_check=False)


def test_a_refinement_cell_without_its_limit_ends_the_run(tmp_path):
    root = add_energy_cell(tiny_root(tmp_path), limit=None)
    with pytest.raises(SystemExit, match="no limit for.*energy_kpt_rel"):
        execute(root, CELL, 0, 0.3, False, device="cpu", chips_check=False)


def test_refinement_without_its_step_size_ends_the_run(tmp_path):
    root = add_energy_cell(tiny_root(tmp_path), drop=("energy_step_size",))
    with pytest.raises(SystemExit, match="without energy_step_size"):
        execute(root, CELL, 0, 0.3, False, device="cpu", chips_check=False)


def test_a_key_the_program_lacks_ends_the_run():
    cfg = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco.json").read_text())
    cfg["model"].update(ENERGY, bogus_key=1)
    with pytest.raises(SystemExit, match="ModelConfig has no key.*bogus_key"):
        serve_closed.build_port(cfg, "cpu")


def test_operations_follow_the_block():
    model = json.loads((ROOT / "h100_bench/configs/detrpose-l-coco.json").read_text())["model"]
    plain = bounds.serve_flops_per_image(model, 640, 1)
    assert round(plain / 1e9, 2) == 109.62
    energy = bounds.serve_flops_per_image({**model, **ENERGY}, 640, 1)
    assert energy > plain and round(energy / 1e9, 1) == 137.9
