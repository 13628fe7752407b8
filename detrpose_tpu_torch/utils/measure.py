"""Timing on the CUDA device: CUDA events, kernels' device time, the
program's spans and the card's power line.

Counterpart of ``detrpose_tpu/utils/measure.py``. The JAX package times by
the slope of a scan over two lengths because its TPU runtime's sync could not
be trusted to bound execution. CUDA events are recorded on the stream the
work runs on and bound it, so a warmed-up run of many calls between two
events is the measurement here (``cuda_time_ms``), and there is no slope.
Where a call's host work (Python, the launch) outlasts its kernels, that time
is the host's; ``kernel_times`` reads the kernels' own device time from
torch.profiler (``traced``). ``span`` is the one way the port opens a
profiler range: a ``record_function`` while a profiler records, a shared
null context otherwise, so a range left in the serving or training path
costs a check when nothing traces it. ``card_power_limit`` reads the card's
name and power limit, to set beside a time.
"""
from __future__ import annotations

import contextlib
import subprocess
from typing import Callable, List, Optional, Tuple

import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` while a profiler is recording, else
    a shared null context: the bare ``record_function`` costs about 10 us
    of host time even with no profiler running, the check about 0.5 us."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def cuda_time_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in milliseconds: ``warmup`` calls, then
    ``iters`` calls between two CUDA events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn: Callable[[], object], n: int = 1) -> List[Tuple[str, float, int]]:
    """[(kernel, device ms per call, launches per call)] of the kernels
    ``fn()`` launches, from torch.profiler's device events over ``n`` calls
    after ``n`` calls under a profiler warm-up step (the first kernels of a
    session can go unrecorded); [] if it saw none."""
    from torch.autograd import DeviceType

    prof = traced(fn, n)
    # device-side events only: a CPU op's self device time repeats its kernels',
    # and a record_function range's device span covers its kernels and gaps
    return [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def traced(fn: Callable[[], object], n: int = 1):
    """A torch.profiler session (CPU and CUDA) whose recorded step is ``n``
    calls of ``fn()``, after a warm-up step of ``n`` untraced calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def card_power_limit() -> Tuple[Optional[str], Optional[float]]:
    """(``name, power.limit`` as nvidia-smi prints them, the limit in W), or
    (None, None) where nvidia-smi does not answer."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    try:
        watts = float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        watts = None
    return line.strip(), watts
