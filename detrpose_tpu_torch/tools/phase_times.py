"""Host and device time of each phase of the training step (the profiler
ranges ``parallel/train_step.py::PHASES``: forward, criterion, backward and
the update, i.e. the clip, AdamW and the EMA), on the CUDA device.

The step is ``chip_smoke.py``'s main path 4: DETRPose-L from seed 0, batch
8 at 640 px, bf16 autocast, accumulation 2, on its synthetic batch. After
two untimed optimiser steps, ``--updates`` optimiser steps run under the
profiler; each phase's host time is its range's CPU time, its device time
the kernels that start inside the range's span on the device. Prints one
JSON line of ms per call of each phase.

``--root DIR`` puts the checkout at DIR first on the import path, so that
one script times two checkouts of this package on the same card. Run the
file by its path, not with ``-m``, so that the package is imported from DIR:

  python detrpose_tpu_torch/tools/phase_times.py [--root DIR] [--updates 4]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Sequence


def range_times(prof, names: Sequence[str]) -> Dict[str, dict]:
    """{range name: {"host_ms", "device_ms", "calls", "spans"}} of the
    ``record_function`` ranges ``names`` in the profiler session ``prof``,
    summed over the session: the range's CPU time, and the device time of
    the kernels that start inside its spans on the device (one stream). A
    name the session did not record is left out."""
    from torch.autograd import DeviceType

    annotation = lambda e: getattr(e, "is_user_annotation", False)
    host = {e.key: e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key in names}
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [(e.time_range.start, e.time_range.elapsed_us()) for e in gpu if not annotation(e)]
    out = {}
    for name in names:
        if name not in host:
            continue
        spans = [(e.time_range.start, e.time_range.end) for e in gpu
                 if annotation(e) and e.name == name]
        device_us = sum(us for start, us in kernels if any(a <= start < b for a, b in spans))
        out[name] = {"host_ms": host[name].cpu_time_total / 1e3, "device_ms": device_us / 1e3,
                     "calls": host[name].count, "spans": len(spans)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="the checkout whose package is timed")
    ap.add_argument("--updates", type=int, default=4, help="traced optimiser steps")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import detrpose_tpu_torch
    from detrpose_tpu_torch.configs import build_model, model_config
    from detrpose_tpu_torch.parallel.train_step import PHASES, make_train_step
    from detrpose_tpu_torch.tools.benchmark import synthetic_train_batch
    from detrpose_tpu_torch.train.optim import make_optimizer
    from detrpose_tpu_torch.utils.measure import traced

    if not torch.cuda.is_available():
        raise SystemExit("phase_times needs a CUDA device")
    accum, batch_size = 2, 8
    model = build_model(model_config("l"), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, grad_accum_steps=accum)
    step = make_train_step(model, opt, 17)
    batch = synthetic_train_batch(batch_size, 640, 17, 60, "cuda", seed=0)
    for _ in range(2 * accum):
        step(batch)
    n = args.updates * accum
    times = range_times(traced(lambda: step(batch), n), PHASES)
    if times.get(PHASES[-1], {}).get("calls") != args.updates:
        raise SystemExit(f"phase_times: the traced run recorded {times} for {PHASES}")
    result = {"package": os.path.dirname(os.path.abspath(detrpose_tpu_torch.__file__)),
              "device": torch.cuda.get_device_name(0), "size": "l", "batch": batch_size,
              "res": 640, "grad_accum_steps": accum, "updates": args.updates,
              "ms_per_call": {name: {"host": t["host_ms"] / t["calls"],
                                     "device": t["device_ms"] / t["calls"]}
                              for name, t in times.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
