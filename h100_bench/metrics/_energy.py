"""Shared arithmetic of the readers of gradient energy refinement: the
work of the program's span ``decoder.energy`` (``TransformerDecoder.forward``
around ``_energy_refine``, one a batch) and of kernel #1's backward range
``msda_fwd_backward``. Each gives None where the trace holds no such span,
as a program that opens none gives.

Attribution. A device event belongs to the refinement when its launch lies
inside the time interval of a ``decoder.energy`` range on any host thread,
not only on the thread that opened it. On the card autograd runs each
step's backward on its own device thread, so the kernels of
``torch.autograd.grad`` are launched there and lie in no range of the main
thread. The rule is sound in serving: the main thread stays inside
``decoder.energy`` (in ``energy.grad``) while autograd's thread launches,
and in a closed loop of one client no other thread launches device work
meanwhile (the staged upload of the next batch starts only once this
batch's results are on the host). Kernel #1's backward range is opened on
the thread that launches its work, so it is read on its own thread.
"""
import bisect

from h100_bench.metrics._program import launched_inside
from h100_bench.trace import DEVICE_CATS

ENERGY = "decoder.energy"
BACKWARD = "msda_fwd_backward"


def launched_in_energy(tr, cats=DEVICE_CATS):
    """The window's device events of ``cats`` launched inside a
    ``decoder.energy`` range, on any host thread."""
    spans = sorted((s, e) for s, e, _ in tr.ranges.get(ENERGY, []))
    starts = [s for s, _ in spans]
    inside = []
    for d in tr.in_window(cats):
        t = d[4]
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            inside.append(d)
    return inside


def backward_device_s(run):
    """Mean device seconds of the work launched inside one
    ``msda_fwd_backward`` range, on the range's own thread; None without a
    trace, without such a range, or where it launched no device work."""
    tr = run.trace
    if tr is None:
        return None
    n = tr.count(BACKWARD)
    total = sum(d[3] for d in launched_inside(tr, BACKWARD)) / 1e6
    return total / n if n and total > 0 else None
