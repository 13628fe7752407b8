"""The CUDA build of the port (detrpose_tpu_torch/ops/cuda/build.py), on the CPU.

A library is named by ``source_digest``: the source, the headers beside it
and the nvcc flags. These tests edit a copy of ``csrc/`` and check that every
edit a build depends on changes the name, so an edited header is never
served by a stale library. No nvcc is needed.
"""
import re
import shutil

import pytest

from detrpose_tpu_torch.ops.cuda.build import CSRC, source_digest


@pytest.fixture
def csrc_copy(tmp_path):
    return shutil.copytree(CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("source", ["msda_fwd.cu", "msda_perquery.cu", "msda_colsin.cu",
                                    "msda_ablate.cu", "msda_tpose.cu"])
@pytest.mark.parametrize("edited", ["msda_gather.cuh", "source"])
def test_digest_follows_source_and_header(csrc_copy, source, edited):
    src = csrc_copy / source
    before = source_digest(src)
    assert source_digest(src) == before          # stable for an unchanged tree
    target = src if edited == "source" else csrc_copy / edited
    target.write_text(target.read_text() + "\n// edited\n")
    assert source_digest(src) != before


def test_digest_matches_the_package_tree(csrc_copy):
    # a copy of the same files names the same library; two sources differ
    for name in ("msda_fwd.cu", "msda_perquery.cu", "msda_colsin.cu"):
        assert source_digest(csrc_copy / name) == source_digest(CSRC / name)
    assert source_digest(CSRC / "msda_fwd.cu") != source_digest(CSRC / "msda_perquery.cu")


def test_header_users_include_it():
    # the five kernels on the shared taps include the header the digest covers
    for name in ("msda_fwd.cu", "msda_perquery.cu", "msda_colsin.cu", "msda_ablate.cu",
                 "msda_tpose.cu"):
        assert '#include "msda_gather.cuh"' in (CSRC / name).read_text(), name


def test_included_headers_are_in_csrc():
    # the digest covers csrc/*.cuh, so every header a source includes must be there
    for src in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (CSRC / name).is_file() and name.endswith(".cuh"), (src.name, name)
