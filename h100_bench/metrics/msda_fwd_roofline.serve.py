"""Kernel #1 (the MSDA forward, ``msda_fwd_kernel``) against its roofline,
in %: its least time at the launch's shapes (``h100_bench/bounds.py``, the
configuration's sizes, the served value type) over its mean device time a
launch in the traced window."""
from h100_bench.bounds import msda_fwd_bound_s

VALUE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernels_named("msda_fwd_kernel")
    if not times:
        return None
    m = run.config["model"]
    queries = m["num_queries"] * (1 + m["num_body_points"])
    bound, _ = msda_fwd_bound_s(m, run.config["res"], run.traffic["batch"], queries,
                                VALUE_BYTES[run.config["dtype"]], run.peaks)
    return 100.0 * bound / (sum(times) / len(times))
