"""Timing on the CUDA device with CUDA events.

Counterpart of ``detrpose_tpu/utils/measure.py``. The JAX package times by
the slope of a scan over two lengths because its TPU runtime's sync could not
be trusted to bound execution. CUDA events are recorded on the stream the
work runs on and bound it, so a warmed-up run of many calls between two
events is the measurement here, and there is no slope. Where a call's host
work (Python, the launch) outlasts its kernels, that time is the host's;
``kernel_times`` reads the kernels' own device time from torch.profiler.
``span`` is the one way the port opens a profiler range: a
``record_function`` while a profiler records, a shared null context
otherwise, so a range left in the serving or training path costs a check
when nothing traces it.

The headline bench (``bench_torch.py``, the port's ``bench.py``) is built
from the parts below: the card's bf16 peak and power limit, its gate
(``throughput_fields``), a chained matmul control, the carried timing loop
and the double-buffered serving copy.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# dense bf16 tensor-core peak TFLOP/s by torch.cuda.get_device_name (the
# data sheet's rate for the SXM part, without sparsity)
DEVICE_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

# the reference DETRPose-L under TensorRT fp16 on a V100, images/s
# (README.md:84 of the reference; bench.py's TRT_L_IPS)
TRT_L_IPS = 1000.0 / 9.50


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


def throughput_fields(ms_per_batch: float, flops_per_batch: Optional[float], batch: int,
                      peak_tflops: Optional[float],
                      baseline_ips: float = TRT_L_IPS) -> dict:
    """Images/s, implied TFLOP/s, MFU and ``bench.py``'s gate (bench.py:179):
    an implied rate above the card's peak is a broken measurement, so it sets
    ``measurement_invalid`` and gives no ``vs_baseline``."""
    ips = batch * 1e3 / ms_per_batch
    tflops = flops_per_batch / (ms_per_batch * 1e-3) / 1e12 if flops_per_batch else None
    mfu = tflops / peak_tflops if (tflops and peak_tflops) else None
    invalid = bool(peak_tflops is not None and tflops is not None and tflops > peak_tflops)
    return {"images_per_sec": ips, "implied_tflops_per_sec": tflops, "mfu": mfu,
            "measurement_invalid": invalid,
            "vs_baseline": None if invalid else ips / baseline_ips}


def timed_ms(fn: Callable[[], object], iters: int, device: torch.device,
             warmup: int = 3) -> float:
    """Mean ms of ``fn()``: CUDA events on the CUDA device (``cuda_time_ms``),
    the host clock on the CPU."""
    if device.type == "cuda":
        return cuda_time_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def matmul_control_tflops(device: torch.device, dim: int = 8192, iters: int = 20) -> float:
    """TFLOP/s of a chained ``dim``^3 bf16 matmul, ``c = (c @ b) / dim``, each
    product reading the last: a check of the card against its peak, taken
    the way the bench is (``timed_ms``)."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(dim, dim, device=device, generator=g).to(torch.bfloat16)
    b = torch.randn(dim, dim, device=device, generator=g).to(torch.bfloat16)
    c = [a]

    def step():
        c[0] = (c[0] @ b) * (1.0 / dim)

    ms = timed_ms(step, iters, device)
    return 2.0 * dim ** 3 / (ms * 1e-3) / 1e12


def carried_time_ms(fwd: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    iters: int, warmup: int = 3) -> float:
    """Mean ms of ``fwd`` over ``iters`` calls (``timed_ms``), each call's input
    perturbed by the previous call's score sum x 1e-12 (``bench.py``'s carry:
    every call depends on the last, and nothing is read on the host).
    ``fwd(x)`` returns the scores."""
    carry = [torch.zeros((), device=x.device)]

    def step():
        scores = fwd(x + (carry[0] * 1e-12).to(x.dtype))
        carry[0] = scores.float().sum()

    return timed_ms(step, iters, x.device, warmup)


def h2d_sustained_mbps(host: Sequence[torch.Tensor], device: torch.device, n: int = 12
                       ) -> float:
    """MB/s of ``n`` back-to-back copies of the (pinned, on a CUDA device)
    host batches ``host`` to ``device``, host clock to the last one's end."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    bufs = [host[i % len(host)].to(device, non_blocking=True) for i in range(n)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return sum(b.numel() * b.element_size() for b in bufs) / seconds / 1e6


def serve_double_buffered(fwd_u8: Callable[[torch.Tensor], torch.Tensor],
                          host: Sequence[torch.Tensor], iters: int, device: torch.device
                          ) -> Tuple[float, float]:
    """(seconds, the score sum) of ``iters`` served batches: each uint8 batch
    of ``host`` (pinned) is copied on a copy stream with ``non_blocking=True``
    into one of two device buffers, an event a batch, while the previous
    batch runs ``fwd_u8`` (dequantise, forward, postprocess -> scores) on the
    compute stream; the score sum accumulates on the device and is read once,
    at the end. On the CPU the copies and calls run in turn."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        acc = torch.zeros((), device=device)
        for i in range(iters):
            acc = acc + fwd_u8(host[i % len(host)].to(device)).float().sum()
        return time.perf_counter() - t0, float(acc)
    compute, copy = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    bufs = [torch.empty_like(host[0], device=device) for _ in range(2)]
    copied = [torch.cuda.Event() for _ in range(2)]
    freed = [torch.cuda.Event() for _ in range(2)]

    def copy_in(i):
        with torch.cuda.stream(copy):
            if i >= 2:      # the buffer's last batch has been read
                copy.wait_event(freed[i % 2])
            bufs[i % 2].copy_(host[i % len(host)], non_blocking=True)
            copied[i % 2].record(copy)

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    acc = torch.zeros((), device=device)
    copy_in(0)
    for i in range(iters):
        if i + 1 < iters:
            copy_in(i + 1)
        compute.wait_event(copied[i % 2])
        acc = acc + fwd_u8(bufs[i % 2]).float().sum()
        freed[i % 2].record(compute)
    total = float(acc)
    return time.perf_counter() - t0, total
