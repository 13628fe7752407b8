"""Stage ablations of the per-point MSDA kernel (kernel #5), by mode and tile.

Counterpart of ``tools_local_msda_ablate.py``, at its shapes (those of
``tools/msda_v2.py``). The inputs are packed once, as in the TPU tool, and
each of the four modes (``ops/cuda/msda_ablate.py``: ``full``, ``no_cexp``,
``stage1_only``, ``io_only``) is timed alone at each point tile per block in
place of the TPU's TP 512 and 1024. Before the timing each (mode, tile) is
checked against its plain version within 1e-5 of max|ref|. A (mode, tile)
has two times: ms per call between CUDA events over back-to-back calls, which
the host's launch work bounds where a kernel is shorter, and the kernels' own
device time from torch.profiler. Prints one line per (mode, tile) and one
JSON line, ``{"<mode>_tp<tile>": ms, ..., "device_ms": {"<mode>_tp<tile>":
ms, ...}, "device": ...}``.

  python -m detrpose_tpu_torch.tools.msda_ablate [--batch 32] [--res 640]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from ..ops.cuda import msda_ablate
from ..ops.cuda.msda_ablate import MODES, TILES, msda_ablate_plain
from ..ops.msda_pack import level_shapes, pack_points, pack_values_xminor
from ..utils.device import resolve_device
from ..utils.measure import cuda_time_ms, kernel_times
from .pallas_bench import l_inputs

TOL = 1e-5    # of max|ref|: the same float32 sums in another order


def pack(batch: int = 32, res: int = 640, device: torch.device | str = "cuda", seed: int = 0):
    """The tool's inputs, packed: (points, values, shapes)."""
    value_levels, loc, aw = l_inputs(batch, res, torch.bfloat16, resolve_device(device), seed)
    shapes = level_shapes(value_levels)
    return pack_points(loc, aw, shapes), pack_values_xminor(value_levels), shapes


def check(points, values, shapes) -> Dict[str, float]:
    """max|kernel - plain| / max|plain| per "<mode>_tp<tile>"; raises above
    ``TOL``. (On the CPU the wrapper runs the plain version itself.)"""
    errs = {}
    for mode in MODES:
        want = msda_ablate_plain(mode, points, values, shapes)
        scale = want.abs().max().item()
        for tile in TILES:
            got = msda_ablate(mode, points, values, shapes, tile)
            err = (got - want).abs().max().item() / scale
            if not err <= TOL:
                raise AssertionError(f"msda_ablate: {mode} at tile {tile} is off its plain "
                                     f"version by {err:.3e} of max|ref| (limit {TOL})")
            errs[f"{mode}_tp{tile}"] = err
    return errs


def run(batch: int = 32, res: int = 640, iters: int = 50,
        device: torch.device | str = "cuda") -> Dict[str, float]:
    """Check, then time, each (mode, tile); the result the tool prints."""
    dev = resolve_device(device)
    points, values, shapes = pack(batch, res, dev)
    results, device_ms = {}, {}
    with torch.no_grad():
        check(points, values, shapes)
        for mode in MODES:
            for tile in TILES:
                def call(m=mode, t=tile):
                    return msda_ablate(m, points, values, shapes, t)
                ms = cuda_time_ms(call, iters)
                dev_ms = sum(k[1] for k in kernel_times(call, iters))
                results[f"{mode}_tp{tile}"] = ms
                device_ms[f"{mode}_tp{tile}"] = dev_ms
                print(f"{mode:>12} tile={tile}: {ms:8.4f} ms/call, kernels {dev_ms:8.4f} ms "
                      "device time", flush=True)
    results["device_ms"] = device_ms
    results["device"] = torch.cuda.get_device_name(dev)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=640)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    results = run(args.batch, args.res, args.iters)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
