"""Where the serving time goes: the DETRPose forward timed stage by stage.

Counterpart of ``tools_local_component_slope.py``: the same four stages on
the same weights (seed 0) and input (uniform [0, 1] from numpy seed 0),

  backbone               HGNetv2 (or ResNet) feature maps
  backbone+encoder       + the hybrid encoder
  full (no postprocess)  + the transformer: query selection and decoder
  full + postprocess     + the top-k decode

and the same three deltas (encoder, transformer, postprocess) under the
same JSON keys. Each stage is timed with CUDA events over ``iters`` calls
after a warm-up, each call's input carried from the previous call's output
(``utils/measure.py::carried_time_ms``), in bf16, with kernel #1's launches
a call (0, 0, 6, 6 at L). The eager forward is partly host-bound, and its
time moves by a few percent from run to run, more than the postprocess
takes: so the stages are timed in ``rounds`` rounds, in turn, and each
keeps its fastest round, and the decode is also timed alone on one
forward's output (``postprocess (alone)``). ``device="cpu"`` times by the
host clock.

  python -m detrpose_tpu_torch.tools.component_slope [size] [batch] [res] [iters]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from ..configs import build_model, model_config
from ..models import postprocess
from ..utils.device import resolve_device
from ..utils.measure import carried_time_ms, timed_ms
from .benchmark import launch_counts

STAGES = ("backbone", "backbone+encoder", "full (no postprocess)", "full + postprocess")
DELTAS = {"encoder (delta)": ("backbone+encoder", "backbone"),
          "transformer (delta)": ("full (no postprocess)", "backbone+encoder"),
          "postprocess (delta)": ("full + postprocess", "full (no postprocess)")}
ALONE = "postprocess (alone)"


def first_leaf(out) -> torch.Tensor:
    """The first tensor of a stage's output (a list of maps, a dict by sorted
    key, or a tuple), as JAX's ``jax.tree.leaves(out)[0]``."""
    while not torch.is_tensor(out):
        out = out[sorted(out)[0]] if isinstance(out, dict) else out[0]
    return out


def stage_fns(model: torch.nn.Module, sizes: torch.Tensor, num_body_points: int
              ) -> Dict[str, Callable[[torch.Tensor], object]]:
    """Each stage as a function of the images (B, 3, H, W)."""
    def bb_enc(x):
        return model.encoder(model.backbone(x))

    def full(x):
        return model.transformer(bb_enc(x))

    return {"backbone": model.backbone, "backbone+encoder": bb_enc,
            "full (no postprocess)": full,
            "full + postprocess": lambda x: postprocess(full(x), sizes,
                                                        num_body_points=num_body_points)}


def component_slope(size: str = "l", batch: int = 32, res: int = 640, iters: int = 10,
                    dtype: torch.dtype = torch.bfloat16, warmup: int = 3, rounds: int = 3,
                    device: torch.device | str = "cuda") -> Dict[str, object]:
    """{stage or delta: ms a batch, the fastest of ``rounds``} and, under
    "launches", each stage's kernel launches a call."""
    dev = resolve_device(device)
    cfg = model_config(size, dtype=dtype)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 3, res, res)).astype(np.float32))
    x = x.to(dev, dtype)
    sizes = torch.full((batch, 2), float(res), device=dev)
    fns = stage_fns(model, sizes, cfg.num_body_points)
    out: Dict[str, object] = {}
    launches = {}
    with torch.no_grad():
        for name, fn in fns.items():
            before = launch_counts()
            fn(x)
            after = launch_counts()
            launches[name] = {k: after[k] - before[k] for k in after}
        for _ in range(rounds):
            for name, fn in fns.items():
                ms = carried_time_ms(lambda xi, fn=fn: first_leaf(fn(xi)), x, iters, warmup)
                out[name] = min(out.get(name, ms), ms)
        # the decode alone, on one forward's output: smaller than the
        # stages' spread, so its delta can come out negative
        full = fns["full (no postprocess)"](x)
        out[ALONE] = timed_ms(lambda: postprocess(full, sizes,
                                                  num_body_points=cfg.num_body_points),
                              iters, dev, warmup)
    for name, (a, b) in DELTAS.items():
        out[name] = out[a] - out[b]
    out["launches"] = launches
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("size", nargs="?", default="l", choices=list("nsmlx"))
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("res", nargs="?", type=int, default=640)
    p.add_argument("iters", nargs="?", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    r = component_slope(args.size, args.batch, args.res, args.iters,
                        torch.bfloat16 if dev.type == "cuda" else torch.float32, device=dev)
    for name in STAGES + tuple(DELTAS) + (ALONE,):
        print(f"{name:>28}: {r[name]:9.3f} ms/batch", flush=True)
    print(json.dumps({k: (v if k == "launches" else round(v, 3)) for k, v in r.items()}))
    return r


if __name__ == "__main__":
    main()
