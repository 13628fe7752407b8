"""Convert an orbax checkpoint of the JAX package into a ``.pth`` this
package reads (``utils/convert.py::convert_orbax``: the live weights and
statistics, the EMA stream, the counters, and AdamW's moments, step counts
and partial gradient accumulation from the optax state, through
``optimizer_from_optax``).

``tools/infer.py``, ``tools/export.py``, ``Trainer.resume`` and
``tools/train.py --resume`` convert an orbax directory in memory, which
needs orbax; where it is not installed, convert beforehand where it is:

  python -m detrpose_tpu_torch.tools.convert_orbax output/checkpoint ckpt.pth
"""
from __future__ import annotations

import argparse

import torch

from ..utils.convert import convert_orbax


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Convert an orbax checkpoint of the JAX "
                                "package into a .pth this package reads.")
    p.add_argument("src", help="the orbax checkpoint directory")
    p.add_argument("out", help="the .pth to write")
    args = p.parse_args(argv)
    ckpt = convert_orbax(args.src)
    torch.save(ckpt, args.out)
    print(f"{args.src} -> {args.out} ({len(ckpt['model'])} tensors, EMA "
          f"{'with ' + str(ckpt['ema']['updates']) + ' updates' if ckpt['ema'] else 'none'}, "
          f"AdamW state {'carried' if ckpt['optimizer'] else 'left out'} at "
          f"{ckpt['optimizer_updates']} updates and {ckpt['micro']} accumulated micro-batches, "
          f"epoch {ckpt['epoch']})")


if __name__ == "__main__":
    main()
