"""The energy cell on the card at the CPU tests' size (``tiny.py``): the
program is correct on three seeds, the float8 control and a program that
skips the refinement are not. Marked ``gpu``; skips without a CUDA device:

  python -m pytest -m gpu h100_bench/tests/test_h100_bench_energy_gpu.py
"""
import pytest
import torch

from h100_bench.run import execute
from h100_bench.tests.tiny import tiny_root

CELL = "l-coco-energy.video-bs32"


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return tiny_root(tmp_path_factory.mktemp("tiny_energy"))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [21, 2**31 + 22, 23])
def test_refinement_holds_and_its_faults_fail_on_the_card(card_root, seed):
    sound = execute(card_root, CELL, seed, 0.5, False, device="cuda")
    assert sound["correct"] is True, sound["checks"]
    ctl = execute(card_root, CELL, seed, 0.5, False, device="cuda", control="fp8")
    assert ctl["correct"] is False, ctl["checks"]
    skip = execute(card_root, CELL, seed, 0.5, False, device="cuda", fault="skip_energy")
    assert skip["correct"] is False
    assert skip["checks"]["energy_kpt_rel"]["value"] == 1.0
