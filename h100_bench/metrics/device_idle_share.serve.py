"""Share of the traced window, in %, in which no kernel, copy or memset ran
on the device: 1 - (union of their intervals) / window, from torch.profiler."""
from h100_bench.metrics._serve import idle_share


def read(run):
    return idle_share(run)
