"""FastKAN basis kernel calls a batch: the program's ranges ``kan.fused``
(one around each launch of ``csrc/kan_basis.cu`` in
``detrpose_tpu_torch/models/layers.py::FastKANLayer``: two a decoder layer)
inside the window, over its ``pipeline.forward`` ranges; None where the
trace holds no ``kan.fused`` range, as a program that takes the plain path
gives."""
from h100_bench.metrics._program import per_call


def read(run):
    if run.trace is None or not run.trace.count("kan.fused"):
        return None
    return per_call(run, "pipeline.forward", lambda tr: tr.count("kan.fused"))
