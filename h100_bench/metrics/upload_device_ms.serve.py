"""Device ms a batch of the copies launched inside the program's span
``pipeline.upload``: the frames and their sizes sent to the card."""
from h100_bench.metrics._program import per_call


def read(run):
    return per_call(run, "pipeline.upload",
                    lambda tr: 1e3 * tr.device_s("pipeline.upload", cats=("gpu_memcpy",)))
