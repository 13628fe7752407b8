"""The reader of the program's ``kan.fused`` ranges on a small recorded trace
whose answers are known: two batches, each with twelve ranges inside
``pipeline.forward`` (two FastKAN layers in each of six decoder layers), and
the same trace without them, as a program that takes the plain path gives."""
import pytest

from h100_bench.run import ROOT, reader
from h100_bench.tests.test_h100_bench_program_spans import _events, _run

NAME = "kan_fused_calls.serve"


def _with_kernel_ranges():
    ev = _events()
    for off in (0, 500):
        for i in range(12):
            ev.append({"ph": "X", "cat": "user_annotation", "name": "kan.fused",
                       "ts": off + 310 + 7 * i, "dur": 5, "tid": 1})
    return ev


def test_twelve_calls_a_batch(tmp_path):
    assert reader(ROOT, NAME).read(_run(tmp_path, _with_kernel_ranges())) == pytest.approx(12.0)


@pytest.mark.parametrize("program_spans", [True, False])
def test_no_range_gives_none(tmp_path, program_spans):
    run = _run(tmp_path, _events(program_spans))
    assert reader(ROOT, NAME).read(run) is None
    run.trace = None
    assert reader(ROOT, NAME).read(run) is None
