"""The FastKAN decoder FFN against its roofline, in %: its least time for
a batch over all decoder layers (``h100_bench/bounds_kan.py``, the
configuration's sizes, the served type) over the device time a batch of
the work launched inside ``decoder.kan`` (``_kan.py``)."""
import torch

from h100_bench.bounds_kan import kan_bound_s
from h100_bench.metrics._kan import device_ms


def read(run):
    ms = device_ms(run)
    if not ms:
        return None
    m = run.config["model"]
    queries = m["num_queries"] * (1 + m["num_body_points"])
    bound, _ = kan_bound_s(m, run.config["res"], run.traffic["batch"], queries,
                           getattr(torch, run.config["dtype"]).itemsize, run.peaks)
    return 100.0 * bound / (ms / 1e3)
