"""Device ms a batch of the serving entry's own work (upload, uint8 to
float, resize, decode, results to the host): kernels and copies launched
inside the request span but outside the model's forward."""
from h100_bench.metrics._serve import per_request_ms


def read(run):
    return per_request_ms(run, "bench.request", outside=("bench.model",))
