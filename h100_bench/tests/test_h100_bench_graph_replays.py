"""The reader of the program's ``forward.graph`` ranges on the recorded trace
of ``test_h100_bench_program_spans``: with two ranges a batch inside
``pipeline.forward`` (a replay of the backbone's graph and one of the
encoder's), and without them, as a program that replays no graph gives."""
import pytest

from h100_bench.run import ROOT, reader
from h100_bench.tests.test_h100_bench_program_spans import _events, _run

NAME = "forward_graph_replays.serve"


def _with_replays(program_spans=True):
    ev = _events(program_spans)
    for off in (0, 500):
        for a, b in ((106, 199), (201, 299)):
            ev.append({"ph": "X", "cat": "user_annotation", "name": "forward.graph",
                       "ts": off + a, "dur": b - a, "tid": 1})
    return ev


def test_two_replays_in_one_forward(tmp_path):
    assert reader(ROOT, NAME).read(_run(tmp_path, _with_replays())) == pytest.approx(2.0)


@pytest.mark.parametrize("program_spans", [True, False])
def test_no_replay_gives_none(tmp_path, program_spans):
    run = _run(tmp_path, _events(program_spans))
    assert reader(ROOT, NAME).read(run) is None
    run.trace = None
    assert reader(ROOT, NAME).read(run) is None
