"""Deployment export: the serve function as a ``torch.export`` program.

Counterpart of ``detrpose_tpu/tools/export.py``. The serve function is the
deploy-fused model plus postprocess (``fuse_for_deploy`` first, as the
reference's ``model.deploy()``, detrpose.py:69-74), exported by
``torch.export.export`` at a fixed batch and resolution and saved by
``torch.export.save``. The CUDA kernels are custom ops
(``torch.ops.detrpose_tpu_torch.*``), so the saved graph holds the kernel
calls, and running the loaded program launches them.

Its inputs are images (B, 3, res, res) float32 in [0, 1] and the original
(w, h) of each, (B, 2); it returns scores, labels and keypoints as
``tools/infer.py`` does. Weights come from a reference zoo ``.pth``, a
checkpoint of this package's Trainer or the JAX package's orbax directory
(converted in memory, ``utils/convert.py::convert_orbax``), EMA weights preferred, or
are drawn from seed 0.

  python -m detrpose_tpu_torch.tools.export --size l --ckpt detrpose_l.pth \\
      --batch 32 --out exported/detrpose_l --check
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import torch
import torch.nn as nn

# importing the models registers the kernels' custom ops, which load needs
from ..configs import build_model, model_config
from ..models import postprocess
from ..utils.convert import drop_derived, load_torch_checkpoint
from ..utils.deploy import fuse_for_deploy
from ..utils.device import resolve_device

PROGRAM = "program.pt2"


class Serve(nn.Module):
    """Images in [0, 1] and original sizes -> (scores, labels, keypoints)."""

    def __init__(self, model: nn.Module, num_body_points: int, dtype: torch.dtype):
        super().__init__()
        self.model, self.num_body_points, self.dtype = model, num_body_points, dtype

    def forward(self, images: torch.Tensor, orig_sizes: torch.Tensor):
        return postprocess(self.model(images.to(self.dtype)), orig_sizes,
                           num_body_points=self.num_body_points)


def build_serve(size: str, num_body_points: int = 17, ckpt: Optional[str] = None,
                bf16: bool = True, fuse: bool = True,
                device: torch.device | str = "cuda") -> Serve:
    """The serve module, eval mode, no gradients. BatchNorm folds in float32
    before the cast to bf16."""
    dev = resolve_device(device)
    base = build_model(model_config(size, num_body_points=num_body_points), device=dev)
    if ckpt:
        base.load_state_dict(drop_derived(load_torch_checkpoint(ckpt)), strict=True)
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = build_model(model_config(size, num_body_points=num_body_points, dtype=dtype),
                        deploy=fuse, device=dev)
    sd = base.state_dict()
    model.load_state_dict(fuse_for_deploy(sd) if fuse else sd, strict=True)
    return Serve(model, num_body_points, dtype).eval().requires_grad_(False)


def export_model(size: str, num_body_points: int = 17, ckpt: Optional[str] = None,
                 batch: int = 32, res: int = 640, bf16: bool = True, fuse: bool = True,
                 out_dir: str = "exported", device: torch.device | str = "cuda") -> str:
    """Export the serve function of one model size into ``out_dir``."""
    dev = resolve_device(device)
    serve = build_serve(size, num_body_points, ckpt, bf16, fuse, dev)
    example = (torch.zeros(batch, 3, res, res, device=dev),
               torch.full((batch, 2), float(res), device=dev))
    program = torch.export.export(serve, example)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    meta = dict(size=size, num_body_points=num_body_points, batch=batch, res=res,
                bf16=bf16, fused=fuse, device=str(dev))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"exported {size} (batch {batch}, {res}px, bf16={bf16}, fused={fuse}) "
          f"-> {out_dir}")
    return out_dir


def load_exported(out_dir: str) -> Callable:
    """Load a saved program; returns ``run(images, orig_sizes)``."""
    module = torch.export.load(os.path.join(out_dir, PROGRAM)).module()

    def run(images: torch.Tensor, orig_sizes: torch.Tensor):
        with torch.no_grad():
            return module(images, orig_sizes)

    return run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", default="l", choices=["n", "s", "m", "l", "x"])
    p.add_argument("--num-body-points", type=int, default=17)
    p.add_argument("--ckpt", help="a .pth or an orbax directory of the JAX package")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--res", type=int, default=640)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--out", default="exported/detrpose")
    p.add_argument("--check", action="store_true",
                   help="reload the program and run one batch")
    args = p.parse_args(argv)
    out = export_model(args.size, args.num_body_points, args.ckpt, args.batch,
                       args.res, not args.no_bf16, not args.no_fuse, args.out)
    if args.check:
        meta = json.load(open(os.path.join(out, "meta.json")))
        run = load_exported(out)
        x = torch.zeros(args.batch, 3, args.res, args.res, device=meta["device"])
        ts = torch.full((args.batch, 2), float(args.res), device=meta["device"])
        scores, labels, kpts = run(x, ts)
        print(f"check OK: scores {tuple(scores.shape)}, keypoints {tuple(kpts.shape)}")


if __name__ == "__main__":
    main()
