"""MSDA variants side by side: kernel #1 and the per-point kernels #3 and #4.

Counterpart of ``tools_local_msda_v2.py``, at its shapes (DETRPose-L eval
geometry: nH 8, dh 32, nP 4, Lq 1080, levels at strides 8/16/32, bf16
values). Each variant is called with the JAX package's per-level signature,
so its time includes its own packing, as in the TPU tool:

  ship      kernel #1, ``ops/cuda/msda.py::ms_deform_attn_fast``, the control
  colsin    kernel #3, ``ops/cuda/msda_colsin.py::ms_deform_attn_colsin``
  tpose     kernel #4, ``ops/cuda/msda_tpose.py::ms_deform_attn_tpose``
  tpose_ck  the TPU tool's tpose with its column loop in chunks of 16, which
            only capped VMEM: the same function, so kernel #4 again

Each variant is first checked against the plain gather
(``ops/ms_deform_attn.py``) on the same bf16 values in float32, within the
TPU tool's 2e-2 of max|ref|, then timed with CUDA events after a warm-up.
Prints one line per variant and one JSON line: per variant ``ms``,
``max_rel_err`` and the ``kernel`` it ran, and the ``device``.

  python -m detrpose_tpu_torch.tools.msda_v2 [--batch 32] [--res 640] [variants ...]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import torch

from ..ops.cuda import ms_deform_attn_colsin, ms_deform_attn_fast, ms_deform_attn_tpose
from ..ops.ms_deform_attn import ms_deform_attn
from ..utils.device import resolve_device
from ..utils.measure import cuda_time_ms
from .pallas_bench import l_inputs

# variant -> (the kernel it runs, its op)
VARIANTS = {"ship": ("msda_fwd", ms_deform_attn_fast),
            "colsin": ("msda_colsin", ms_deform_attn_colsin),
            "tpose": ("msda_tpose", ms_deform_attn_tpose),
            "tpose_ck": ("msda_tpose", ms_deform_attn_tpose)}
TOL = 2e-2    # of max|ref|: the TPU tool's limit (v2.py:238)


def reference(value_levels, loc, aw) -> torch.Tensor:
    """The plain gather on the values in float32, (B, Lq, nH*dh)."""
    return ms_deform_attn([v.float() for v in value_levels], loc, aw)


def check(variant: str, value_levels, loc, aw, ref: torch.Tensor) -> float:
    """max|variant - ref| / max|ref|; raises above ``TOL``."""
    got = VARIANTS[variant][1](value_levels, loc, aw).float()
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    if not err < TOL:
        raise AssertionError(f"msda_v2: {variant} is off the gather by {err:.3e} "
                             f"of max|ref| (limit {TOL})")
    return err


def run(batch: int = 32, res: int = 640, variants: Sequence[str] = tuple(VARIANTS),
        iters: int = 50, device: torch.device | str = "cuda") -> Dict[str, dict]:
    """Check, then time, each variant; the result the tool prints."""
    dev = resolve_device(device)
    value_levels, loc, aw = l_inputs(batch, res, torch.bfloat16, dev)
    results = {}
    with torch.no_grad():
        ref = reference(value_levels, loc, aw)
        for name in variants:
            kernel, op = VARIANTS[name]
            err = check(name, value_levels, loc, aw, ref)
            ms = cuda_time_ms(lambda op=op: op(value_levels, loc, aw), iters)
            results[name] = {"ms": ms, "max_rel_err": err, "kernel": kernel}
            print(name, results[name], flush=True)
    results["device"] = torch.cuda.get_device_name(dev)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=640)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("variants", nargs="*", help=f"of {list(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    results = run(args.batch, args.res, args.variants or tuple(VARIANTS), args.iters)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
