"""Kernels, copies and memsets a batch launched inside the program's span
``decoder.kan`` (the FastKAN decoder FFN) on its own host thread
(``_kan.py``)."""
from h100_bench.metrics._kan import per_batch


def read(run):
    return per_batch(run, len)
