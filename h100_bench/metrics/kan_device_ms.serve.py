"""Device ms a batch of the work launched inside the program's span
``decoder.kan`` (the FastKAN decoder FFN, one a layer) on its own host
thread (``_kan.py``)."""
from h100_bench.metrics._kan import device_ms


def read(run):
    return device_ms(run)
