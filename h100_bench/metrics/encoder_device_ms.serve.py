"""Device ms a batch of the work launched inside ``model.encoder``'s forward
(a span the benchmark opens and closes with forward hooks)."""
from h100_bench.metrics._serve import per_request_ms


def read(run):
    return per_request_ms(run, "model.encoder")
