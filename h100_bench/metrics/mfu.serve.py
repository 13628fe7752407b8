"""The whole served step's share of the card's dense bf16 peak, in %: the
operations of an image's forward and decode (counted over the reference on
the meta device, ``h100_bench/bounds.py``) times the images of the traced
window, over the window's seconds, over the peak."""


def read(run):
    if run.trace is None or not run.trace.window_s() or not run.images:
        return None
    return (100.0 * run.flops_per_image * run.images / run.trace.window_s()
            / run.peaks["bf16_flop_per_s"])
