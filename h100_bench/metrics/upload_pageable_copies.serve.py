"""Copies a batch launched inside the program's span ``pipeline.upload``
whose name marks pageable host memory (``Pageable``): each goes through
CUDA's staging buffer and holds the host until it ends. 0 where the
frames and their sizes leave from pinned memory."""
from h100_bench.metrics._program import launched_inside, per_call


def read(run):
    return per_call(run, "pipeline.upload", lambda tr: sum(
        1 for d in launched_inside(tr, "pipeline.upload", ("gpu_memcpy",))
        if "Pageable" in d[0]))
