"""The backward of kernel #1's op (``msda_fwd_backward``, the gradient that
energy refinement takes) against its roofline, in %: its least time at the
launch's shapes (``h100_bench/bounds_msda_bwd.py``, the configuration's
sizes, the served value type) over the mean device time of the work
launched inside one ``msda_fwd_backward`` range, on its own thread."""
import torch

from h100_bench.bounds_msda_bwd import msda_bwd_bound_s
from h100_bench.metrics._energy import backward_device_s


def read(run):
    mean = backward_device_s(run)
    if mean is None:
        return None
    m = run.config["model"]
    queries = m["num_queries"] * (1 + m["num_body_points"])
    bound, _ = msda_bwd_bound_s(m, run.config["res"], run.traffic["batch"], queries,
                                getattr(torch, run.config["dtype"]).itemsize, run.peaks)
    return 100.0 * bound / mean
