"""Timing on the CUDA device with CUDA events.

Counterpart of ``detrpose_tpu/utils/measure.py``. The JAX package times by
the slope of a scan over two lengths because its TPU runtime's sync could not
be trusted to bound execution. CUDA events are recorded on the stream the
work runs on and bound it, so a warmed-up run of many calls between two
events is the measurement here, and there is no slope.
"""
from __future__ import annotations

from typing import Callable

import torch


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
