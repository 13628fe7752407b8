"""The MSDA forward's three paths side by side at DETRPose-L eval shapes.

Counterpart of ``detrpose_tpu/tools/pallas_bench.py``, with its flags. Each
path is called with the JAX package's per-level signature, so its time
includes its packing of the value map:

  plain                   ops/ms_deform_attn.py (JAX's "xla gather")
  kernel #1 (auto)        ops/cuda/msda.py::ms_deform_attn_fast
  kernel #2 (pallas)      ops/cuda/msda_perquery.py::ms_deform_attn_pallas

Times are means over ``--iters`` calls between CUDA events, after a warm-up.

  python -m detrpose_tpu_torch.tools.pallas_bench [--batch 32] [--res 640]
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from ..ops.cuda import ms_deform_attn_fast, ms_deform_attn_pallas
from ..ops.ms_deform_attn import ms_deform_attn
from ..utils.device import resolve_device
from ..utils.measure import cuda_time_ms

PATHS = {"plain (xla gather)": ms_deform_attn,
         "kernel #1 (auto)": ms_deform_attn_fast,
         "kernel #2 (pallas)": ms_deform_attn_pallas}


def l_inputs(batch: int = 32, res: int = 640, dtype: torch.dtype = torch.bfloat16,
             device: torch.device | str = "cuda", seed: int = 0):
    """DETRPose-L eval geometry: 60 queries x (1 + 17) tokens, 8 heads,
    d_head 32, 4 points, levels at strides 8/16/32. Returns (value_levels,
    locations, weights), locations in [0, 1]."""
    dev = resolve_device(device)
    B, nH, nP, dh, Lq = batch, 8, 4, 32, 60 * 18
    s = res // 8
    shapes = [(s, s), (s // 2, s // 2), (s // 4, s // 4)]
    g = torch.Generator(device=dev).manual_seed(seed)
    value_levels = [torch.randn(B, H, W, nH, dh, generator=g, device=dev).to(dtype)
                    for H, W in shapes]
    loc = torch.rand(B, Lq, nH, len(shapes), nP, 2, generator=g, device=dev)
    aw = torch.rand(B, Lq, nH, len(shapes), nP, generator=g, device=dev)
    return value_levels, loc, aw / aw.sum(dim=(-1, -2), keepdim=True)


def bench(batch: int = 32, res: int = 640, iters: int = 50, dtype: str = "bfloat16",
          device: torch.device | str = "cuda") -> Dict[str, float]:
    """ms/call of each path at the L eval shapes, on the CUDA device."""
    value_levels, loc, aw = l_inputs(batch, res, getattr(torch, dtype), device)
    with torch.no_grad():
        return {name: cuda_time_ms(lambda fn=fn: fn(value_levels, loc, aw), iters)
                for name, fn in PATHS.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=640)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)
    times = bench(args.batch, args.res, args.iters, args.dtype)
    for name, ms in times.items():
        print(f"{name:>24}: {ms:8.3f} ms/call  ({ms / args.batch * 1000:7.1f} us/img)")
    (best, t1), (_, t2) = sorted(times.items(), key=lambda kv: kv[1])[:2]
    print(f"winner: {best}  (speedup {t2 / t1:.2f}x over the next)")
    return times


if __name__ == "__main__":
    main()
