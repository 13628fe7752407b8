"""Kernels, copies and memsets a batch launched inside the program's span
``pipeline.forward`` (the model's forward)."""
from h100_bench.metrics._program import launched_inside, per_call


def read(run):
    return per_call(run, "pipeline.forward",
                    lambda tr: len(launched_inside(tr, "pipeline.forward")))
