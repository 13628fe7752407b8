"""The float8 control and a sound run of each cell on the card, at the
CPU tests' size (``tiny.py``): the control is not correct on any of three
seeds, the program is. Marked ``gpu``; skips without a CUDA device:

  python -m pytest -m gpu h100_bench/tests/test_h100_bench_gpu.py
"""
import pytest
import torch

from h100_bench.run import execute
from h100_bench.tests.tiny import tiny_root

CELLS = ("l-coco.video-bs32",)


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds_on_the_card(card_root, cell, seed):
    sound = execute(card_root, cell, seed, 0.5, False, device="cuda")
    assert sound["correct"] is True, sound["checks"]
    ctl = execute(card_root, cell, seed, 0.5, False, device="cuda", control="fp8")
    assert ctl["correct"] is False, ctl["checks"]
