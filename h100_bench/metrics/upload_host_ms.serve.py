"""Host ms a batch inside the program's span ``pipeline.upload``, which a
synchronous copy from pageable memory holds until the copy ends."""
from h100_bench.metrics._program import per_call


def read(run):
    return per_call(run, "pipeline.upload", lambda tr: 1e3 * tr.host_s("pipeline.upload"))
