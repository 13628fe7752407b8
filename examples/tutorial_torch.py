"""DETRPose tutorial on the PyTorch / CUDA port: the reference's
DETRPose_tutorial.ipynb (model -> inference -> visualisation) as a script,
counterpart of examples/tutorial.py.

Five steps:
  1. build a model from a size config,
  2. get weights (drawn from seed 0 here; a zoo or Trainer ``.pth``, or an
     orbax checkpoint directory of the JAX package, plug into the same line),
  3. the serve function (resize, normalise, forward and top-k decode on the
     device: ``tools/infer.py::build_pipeline``),
  4. run it on an image,
  5. draw the predicted poses and save the overlay.

  python examples/tutorial_torch.py                               # CUDA, DETRPose-L
  python examples/tutorial_torch.py --size n --res 160 --device cpu
  python examples/tutorial_torch.py --ckpt detrpose_l.pth --image photo.jpg

Without ``--image`` the image is synthesised from ``--seed``. bf16 on the
CUDA device, float32 on the CPU. The latencies printed are host-clock times
of one call up to ``torch.cuda.synchronize``, on the device named beside them.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def synthetic_image(seed: int, w: int = 640, h: int = 480):
    """A (h, w, 3) uint8 noise image drawn from ``seed``."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="l", choices=list("nsmlx"))
    ap.add_argument("--res", type=int, default=640)
    ap.add_argument("--ckpt", default=None,
                    help="a .pth or an orbax directory of the JAX package (default: "
                         "weights drawn from seed 0)")
    ap.add_argument("--image", default=None, help="default: synthesised from --seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", default=os.path.join(tempfile.gettempdir(),
                                                     "tutorial_torch_out.jpg"))
    ap.add_argument("--thresh", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import cv2
    import numpy as np
    import torch
    from PIL import Image

    from detrpose_tpu_torch.tools.benchmark import launch_counts
    from detrpose_tpu_torch.tools.infer import build_pipeline, draw_poses
    from detrpose_tpu_torch.utils.device import resolve_device

    # ---- step 0: the device. Entry points run on the CUDA device unless
    # the CPU is asked for.
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"device: {dev} ({where})")

    # ---- steps 1-3: model, weights, serve function. build_pipeline is what
    # the inference command line uses (tools/infer.py): the tutorial and the
    # production path are the same code.
    t0 = time.perf_counter()
    run = build_pipeline(args.size, 17, args.ckpt, res=args.res, device=dev,
                         dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    print(f"model ready in {time.perf_counter() - t0:.1f} s "
          f"({args.ckpt or 'weights drawn from seed 0'})")

    # ---- step 4: inference. The serve function takes the uint8 image and its
    # original (w, h); resize, normalisation, forward and decode run on the
    # device.
    if args.image:
        img = np.asarray(Image.open(args.image).convert("RGB"))
    else:
        img = synthetic_image(args.seed)
        print(f"no --image: a {img.shape[1]}x{img.shape[0]} image synthesised from seed "
              f"{args.seed}")
    h, w = img.shape[:2]

    def call():
        t = time.perf_counter()
        out = run(img, (w, h))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t) * 1e3

    _, first_ms = call()
    print(f"first call: {first_ms:.3f} ms on {where} (kernels loaded, allocator and "
          f"cuDNN warm-up included)")
    (scores, labels, kpts), steady_ms = call()
    print(f"steady call: {steady_ms:.3f} ms on {where}")
    # the hand-written MSDA kernels each count their launches (none on the
    # CPU, where the plain PyTorch version runs)
    launches = launch_counts()
    print(f"kernel launches in the 2 calls: {json.dumps(launches)}")

    scores = scores[0].float().cpu().numpy()
    kpts = kpts[0].float().cpu().numpy()
    n_above = int((scores > args.thresh).sum())
    print(f"top score {scores.max():.3f}; {n_above} poses above {args.thresh}")

    # ---- step 5: the overlay. With drawn weights the poses are arbitrary:
    # load a checkpoint for meaningful ones.
    overlay = draw_poses(img[:, :, ::-1], kpts, scores, thresh=args.thresh)
    parent = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(parent, exist_ok=True)
    if not cv2.imwrite(args.output, overlay):
        raise SystemExit(f"could not write {args.output}")
    print(f"overlay written to {args.output}")
    return {"first_ms": first_ms, "steady_ms": steady_ms, "output": args.output,
            "poses_above": n_above, "launches": launches}


if __name__ == "__main__":
    main()
