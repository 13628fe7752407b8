"""CUDA graph replays a batch: the program's ranges ``forward.graph`` (one
around each replay of a stage's graph, ``detrpose_tpu_torch/utils/
graphs.py::GraphedStage``) inside the window, over its ``pipeline.forward``
ranges; None where the trace holds no ``forward.graph`` range, as a program
that replays no graph gives."""
from h100_bench.metrics._program import per_call


def read(run):
    if run.trace is None or not run.trace.count("forward.graph"):
        return None
    return per_call(run, "pipeline.forward", lambda tr: tr.count("forward.graph"))
