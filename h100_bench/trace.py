"""Spans the benchmark places, the profiled window, and the reading of its
device trace.

Spans are ``record_function`` ranges: ``span(name)`` around a call, and
``ModuleSpans``, forward pre- and post-hooks that open and close a range
around a module's forward (``model.backbone`` and the like). The program's
own ranges are read the same way.

``profiled(...)`` runs a warm-up step and then the traced items under
torch.profiler (CPU and CUDA activity), the traced items inside the range
``bench.window``, and returns the session's chrome trace parsed into a
``Trace``. A kernel or copy belongs to a range when the host call that
launched it (its ``cuda_runtime`` event, joined by correlation id) lies
inside that range on the same host thread; so a range's device time is the
device time of the work it launched, wherever on the device that work ran.
Work launched from autograd's own thread lies in no range of the main
thread.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A ``record_function`` range named ``name`` (a context manager)."""
    return torch.profiler.record_function(name)


class ModuleSpans:
    """A range ``name`` around each forward of each ``{name: module}``,
    opened by a forward pre-hook and closed by a forward hook."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.handles = []
        for name, module in modules.items():
            open_ranges: List = []

            def pre(_m, _args, name=name, open_ranges=open_ranges):
                rf = span(name)
                rf.__enter__()
                open_ranges.append(rf)

            def post(_m, _args, _out, open_ranges=open_ranges):
                open_ranges.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(pre),
                             module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Trace:
    """The events of one profiled window, in microseconds on the host's
    clock (the device's events are mapped onto it by the profiler).

    ``device``: (name, category, start, duration, launch time, launch thread)
    of each kernel, copy and memset; ``ranges``: {name: sorted [(start, end,
    thread)]} of the host's ``record_function`` ranges; ``window``: (start,
    end) of ``bench.window``.
    """

    def __init__(self, events: Iterable[dict]):
        launches: Dict[int, Tuple[float, int]] = {}
        device, ranges = [], defaultdict(list)
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            if cat == "cuda_runtime" or cat == "cuda_driver":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (float(e["ts"]), e.get("tid"))
            elif cat in DEVICE_CATS:
                device.append(e)
            elif cat == "user_annotation":
                ts = float(e["ts"])
                ranges[e["name"]].append((ts, ts + float(e.get("dur", 0.0)), e.get("tid")))
        self.device = []
        for e in device:
            launch, tid = launches.get(e.get("args", {}).get("correlation"), (None, None))
            self.device.append((e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0)),
                                launch, tid))
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self.starts = {k: [s for s, _, _ in v] for k, v in self.ranges.items()}
        win = self.ranges.get(WINDOW, [])
        self.window = (win[0][0], win[0][1]) if win else None

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the window ----------------------------------------------------------
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6 if self.window else 0.0

    def in_window(self, cats: Sequence[str] = DEVICE_CATS):
        """Device events of ``cats`` that start inside the window."""
        if not self.window:
            return []
        a, b = self.window
        return [d for d in self.device if d[1] in cats and a <= d[2] < b]

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or memset ran: the
        union of their intervals, clipped to the window."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        if not self.window:
            return []
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, _, s, d, _, _ in self.device
                       if s < hi and s + d > lo)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    # -- ranges --------------------------------------------------------------
    def count(self, name: str) -> int:
        """Host ranges ``name`` that lie inside the window."""
        if not self.window:
            return 0
        a, b = self.window
        return sum(1 for s, e, _ in self.ranges.get(name, []) if s >= a and e <= b)

    def host_s(self, name: str) -> float:
        """Host seconds of the ranges ``name`` inside the window."""
        if not self.window:
            return 0.0
        a, b = self.window
        return sum(e - s for s, e, _ in self.ranges.get(name, []) if s >= a and e <= b) / 1e6

    def _inside(self, name: str) -> Callable[[Optional[float], Optional[int]], bool]:
        spans, starts = self.ranges.get(name, []), self.starts.get(name, [])

        def inside(t, tid):
            # ranges of one name never overlap on a thread: the last one
            # started before t is the only one that can hold it
            if t is None:
                return False
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and spans[i][1] >= t and spans[i][2] == tid
        return inside

    def device_s(self, name: str, outside: Sequence[str] = (),
                 cats: Sequence[str] = DEVICE_CATS) -> float:
        """Device seconds of the work of ``cats`` launched inside the ranges
        ``name`` (and inside none of ``outside``), within the window."""
        inside = self._inside(name)
        exclude = [self._inside(n) for n in outside]
        return sum(d for _, _, _, d, t, tid in self.in_window(cats)
                   if inside(t, tid) and not any(x(t, tid) for x in exclude)) / 1e6

    def kernels_named(self, part: str) -> List[float]:
        """Durations (seconds) of the window's kernels whose name holds ``part``."""
        return [d / 1e6 for n, _, _, d, _, _ in self.in_window(("kernel",)) if part in n]

    # -- what the driver's ledger keeps --------------------------------------
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the idle
        gaps of the window summed by the innermost host range open at each
        gap's start ("no range" where none was)."""
        ops: Dict[str, float] = defaultdict(float)
        for n, _, _, d, _, _ in self.in_window():
            ops[n[:160]] += d / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        busy = self.busy_intervals()
        if self.window:
            edges = [self.window[0]] + [t for ab in busy for t in ab] + [self.window[1]]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps[self.host_range_at(a)] += (b - a) / 1e6
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(ops), "idle_gaps": order(gaps)}

    def host_range_at(self, t: float) -> str:
        """The innermost range (other than the window) open at host time ``t``."""
        best, start = "no range", -1.0
        for name, spans in self.ranges.items():
            if name == WINDOW or name.startswith("ProfilerStep"):
                continue
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and spans[i][1] >= t and spans[i][0] > start:
                best, start = name, spans[i][0]
        return best


def profiled(run_item: Callable[[int], None], warmup_items: int, items: int) -> Trace:
    """Run ``run_item(i)`` for ``warmup_items`` items under the profiler's
    warm-up step, then ``items`` more inside ``bench.window`` under its
    active step, and return the active step's trace. Each step ends with a
    device synchronise."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(warmup_items):
                run_item(i)
            sync()
            prof.step()
            with span(WINDOW):
                for i in range(items):
                    run_item(warmup_items + i)
                sync()
            prof.step()
        return Trace.from_file(path)
    finally:
        os.unlink(path)
