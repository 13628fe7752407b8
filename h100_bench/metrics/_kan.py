"""Shared arithmetic of the readers of the FastKAN decoder FFN: the work
launched inside the program's span ``decoder.kan``
(``DeformableDecoderLayer.forward`` around ``kan1`` -> ReLU -> ``kan2`` ->
``out_linear``, one a decoder layer) on its own host thread, a batch: over
the window's ``pipeline.forward`` ranges. Each gives None where the trace
holds no such span, as a program that opens none gives."""
from h100_bench.metrics._program import launched_inside, per_call

KAN = "decoder.kan"


def per_batch(run, total):
    """``total(events)`` of the device events launched inside ``decoder.kan``
    over the window's ``pipeline.forward`` ranges; None without a trace or
    without such a span."""
    tr = run.trace
    if tr is None or not tr.count(KAN):
        return None
    return per_call(run, "pipeline.forward", lambda tr: total(launched_inside(tr, KAN)))


def device_ms(run):
    """Device ms a batch of the work launched inside ``decoder.kan``."""
    return per_batch(run, lambda events: sum(d[3] for d in events) / 1e3)
