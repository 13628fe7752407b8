"""Shared arithmetic of the readers of the program's own spans (the
``pipeline.*`` ranges that ``detrpose_tpu_torch/tools/infer.py::Pipeline``
opens): a quantity of the traced window over the calls of one span. Each
gives None where the trace holds no such span, as a program that opens none
gives."""
import bisect
from collections import defaultdict

from h100_bench.trace import DEVICE_CATS


def per_call(run, name, total):
    """``total(trace)`` over the ranges ``name`` inside the window; None
    without a trace or without such a range."""
    tr = run.trace
    if tr is None:
        return None
    n = tr.count(name)
    return total(tr) / n if n else None


def launched_inside(tr, name, cats=DEVICE_CATS):
    """The window's device events of ``cats`` whose launch lies inside a
    range ``name`` on the launching host thread."""
    by_thread = defaultdict(list)
    for s, e, tid in tr.ranges.get(name, []):
        by_thread[tid].append((s, e))
    starts = {tid: [s for s, _ in spans] for tid, spans in by_thread.items()}
    inside = []
    for d in tr.in_window(cats):
        t, tid = d[4], d[5]
        if t is None or tid not in by_thread:
            continue
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and by_thread[tid][i][1] >= t:
            inside.append(d)
    return inside


def idle_inside_s(tr, name):
    """Seconds of the ranges ``name`` inside the window in which no kernel,
    copy or memset ran: each range's length less its overlap with the
    device's busy intervals."""
    busy = tr.busy_intervals()
    starts = [a for a, _ in busy]
    a0, b0 = tr.window
    idle = 0.0
    for s, e, _ in tr.ranges.get(name, []):
        if s < a0 or e > b0:
            continue
        covered = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(busy[i][1], e) - max(busy[i][0], s))
            i += 1
        idle += (e - s) - covered
    return idle / 1e6
