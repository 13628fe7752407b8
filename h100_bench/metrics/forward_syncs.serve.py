"""Copies a batch launched inside the program's span ``pipeline.forward``
whose name marks pageable host memory (``Pageable``, either direction):
each one holds the host until the device has drained its queue."""
from h100_bench.metrics._program import launched_inside, per_call


def read(run):
    return per_call(run, "pipeline.forward", lambda tr: sum(
        1 for d in launched_inside(tr, "pipeline.forward", ("gpu_memcpy",))
        if "Pageable" in d[0]))
