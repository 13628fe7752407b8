"""Serving entry point: uint8 image(s) -> (scores, labels, keypoints), and the
visual command line over an image, a folder or a video.

Counterpart of ``detrpose_tpu/tools/infer.py``. Reference semantics:
tools/inference/torch_inf.py (square resize, normalise to [0, 1], model,
top-k decode scaled to the original size, threshold 0.5) and
tools/inference/annotator.py (the skeleton overlay).

  run = build_pipeline("l")                       # on the CUDA device
  run = build_pipeline("l", use_energy_refinement=True, grad_energy=True)
  scores, labels, kpts = run(img_u8, (w, h))      # img_u8 (H, W, 3) uint8

  python -m detrpose_tpu_torch.tools.infer --size l --ckpt ckpt.pth --input img.jpg
  python -m detrpose_tpu_torch.tools.infer --size n --input video.mp4 --output out.mp4
  python -m detrpose_tpu_torch.tools.infer --size n --input dir/ --device cpu

``--ckpt`` takes a reference zoo ``.pth``, a checkpoint of this package's
Trainer (``utils/checkpoint.py`` writes the reference's layout) or an orbax
checkpoint directory of the JAX package (converted in memory,
``utils/convert.py::convert_orbax``), EMA weights preferred; without one the weights
are drawn from seed 0. The command line
runs in bf16 on the CUDA device, in float32 with ``--device cpu``.

On a CUDA device ``Pipeline`` sends the frames through a pinned arena of
its own, copied into in chunks by a few host threads, each chunk sent to the
card by an asynchronous copy while the next is filled
(``utils/staging.py``); on the CPU the upload is the plain
``torch.as_tensor``.

A ``torch.profiler`` session around ``Pipeline`` calls shows their spans:
``pipeline.{upload,preprocess,forward,decode}``, and the model's inside.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import build_model, model_config
from ..models import postprocess
from ..utils.convert import drop_derived, load_torch_checkpoint
from ..utils.device import resolve_device
from ..utils.measure import span
from ..utils.staging import StagedUpload

ArrayLike = Union[np.ndarray, torch.Tensor]

COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]
CROWDPOSE_SKELETON = [
    (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (0, 6), (1, 7), (6, 7),
    (6, 8), (7, 9), (8, 10), (9, 11), (12, 13), (0, 13), (1, 13),
]
IMAGE_EXTS = (".jpg", ".jpeg", ".png")
VIDEO_EXTS = (".mp4", ".avi", ".mov")


def preprocess(img_u8: torch.Tensor, res: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, res, res) float32 in [0, 1].

    The resize is bilinear with half-pixel centres and, when it shrinks, an
    antialiasing triangle filter, as ``jax.image.resize(..., "bilinear")``.
    """
    x = img_u8.permute(0, 3, 1, 2).float() / 255.0
    if tuple(x.shape[-2:]) != (res, res):
        x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False,
                          antialias=True)
    return x


class Pipeline:
    """The eval forward plus the top-k decode, on one device; ``model`` is
    the underlying ``DETRPose``.

    On a CUDA device the frames and their sizes reach the card through
    ``staging``, a ``utils/staging.py::StagedUpload``: a pinned arena the
    pipeline keeps, filled in chunks by a few host threads, each chunk sent
    by an asynchronous copy as soon as it is filled. On the CPU the upload
    is the plain ``torch.as_tensor``."""

    def __init__(self, model: torch.nn.Module, res: int, num_body_points: int,
                 dtype: torch.dtype, device: torch.device):
        self.model, self.res, self.num_body_points = model, res, num_body_points
        self.dtype, self.device = dtype, device
        self.staging = StagedUpload(device) if device.type == "cuda" else None

    def upload(self, img_u8: ArrayLike, orig_wh: Union[ArrayLike, Sequence[float]]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(frames, sizes as float32) on the pipeline's device; the caller's
        buffers are free again when it returns."""
        with span("pipeline.upload"):
            if self.staging is not None:
                return self.staging(img_u8, orig_wh)
            return (torch.as_tensor(img_u8).to(self.device),
                    torch.as_tensor(np.asarray(orig_wh, np.float32)).to(self.device))

    @torch.no_grad()
    def __call__(self, img_u8: ArrayLike, orig_wh: Union[ArrayLike, Sequence[float]]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """img_u8 (H, W, 3) or (B, H, W, 3) uint8; orig_wh (2,) or (B, 2), the
        original (w, h) -> scores (B, 60), labels (B, 60), keypoints
        (B, 60, K, 3) in original pixels."""
        img, wh = self.upload(img_u8, orig_wh)
        if img.dim() == 3:
            img, wh = img[None], wh.reshape(1, 2)
        with span("pipeline.preprocess"):
            x = preprocess(img, self.res).to(self.dtype)
        with span("pipeline.forward"):
            out = self.model(x)
        with span("pipeline.decode"):
            return postprocess(out, wh, num_body_points=self.num_body_points)


def build_pipeline(size: str, num_body_points: int = 17, ckpt: Optional[str] = None,
                   res: int = 640, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cuda",
                   generator: Optional[torch.Generator] = None, **overrides) -> Pipeline:
    """Build the serving pipeline of one model size.

    ``overrides`` go to ``model_config`` on top of the preset (a decoder
    variant, e.g. ``use_energy_refinement=True, grad_energy=True``); a key
    ``ModelConfig`` lacks raises ``TypeError``. ``ckpt`` is a reference zoo
    ``.pth``, a Trainer checkpoint or the JAX package's orbax directory (EMA
    weights preferred), loaded into the model the overrides built; without
    one the weights are drawn from ``generator`` (seed 0 if None). Runs on
    the CUDA device unless ``device="cpu"`` is given.
    """
    dev = resolve_device(device)
    cfg = model_config(size, num_body_points=num_body_points, dtype=dtype, **overrides)
    model = build_model(cfg, device=dev, generator=generator)
    if ckpt:
        model.load_state_dict(drop_derived(load_torch_checkpoint(ckpt)), strict=True)
    return Pipeline(model, res, num_body_points, dtype, dev)


def draw_poses(img: np.ndarray, kpts: np.ndarray, scores: np.ndarray,
               thresh: float = 0.5, num_body_points: int = 17) -> np.ndarray:
    """A copy of the BGR image ``img`` with each pose scoring at least
    ``thresh`` drawn: its skeleton's limbs, its keypoints and its score
    (``kpts`` (N, K, 3) in pixels, ``scores`` (N,))."""
    import cv2

    skeleton = COCO_SKELETON if num_body_points == 17 else CROWDPOSE_SKELETON
    out = img.copy()
    for s, kp in zip(scores, kpts):
        if s < thresh:
            continue
        pts = kp[:, :2].astype(int)
        for a, b in skeleton:
            if a < len(pts) and b < len(pts):
                cv2.line(out, tuple(pts[a]), tuple(pts[b]), (60, 200, 60), 2)
        for p in pts:
            cv2.circle(out, tuple(p), 3, (40, 40, 230), -1)
        cv2.putText(out, f"{s:.2f}", tuple(pts[0]), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1)
    return out


def detections(run: Pipeline, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(scores (60,), keypoints (60, K, 3)) of one RGB uint8 image, float32."""
    h, w = rgb.shape[:2]
    scores, _, kpts = run(np.ascontiguousarray(rgb), (w, h))
    return scores[0].float().cpu().numpy(), kpts[0].float().cpu().numpy()


def infer_image(run: Pipeline, path: str, out_path: str, thresh: float) -> int:
    """Draw the poses of the image at ``path`` into ``out_path``; returns
    how many scored above ``thresh``."""
    import cv2
    from PIL import Image

    img = np.array(Image.open(path).convert("RGB"))
    scores, kpts = detections(run, img)
    cv2.imwrite(out_path, draw_poses(img[:, :, ::-1], kpts, scores, thresh,
                                     run.num_body_points))
    n = int((scores > thresh).sum())
    print(f"{path} -> {out_path} ({n} poses)")
    return n


def infer_video(run: Pipeline, path: str, out_path: str, thresh: float) -> int:
    """Draw the poses of every frame of the video at ``path`` into the mp4
    ``out_path``; returns the frame count."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            scores, kpts = detections(run, frame[:, :, ::-1])
            vw.write(draw_poses(frame, kpts, scores, thresh, run.num_body_points))
            n += 1
    finally:
        cap.release()
        vw.release()
    print(f"{path} -> {out_path} ({n} frames)")
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Draw DETRPose skeletons on an image, "
                                "a folder of images or a video.")
    p.add_argument("--size", default="l", choices=["n", "s", "m", "l", "x"])
    p.add_argument("--num-body-points", type=int, default=17)
    p.add_argument("--ckpt", help="a reference .pth, a checkpoint of this package's "
                   "Trainer or an orbax directory of the JAX package (EMA weights "
                   "preferred)")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="inference_out",
                   help="a directory, or a file path for one image or a video")
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    run = build_pipeline(args.size, args.num_body_points, args.ckpt, device=dev,
                         dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    out_is_file = args.output.lower().endswith(IMAGE_EXTS + VIDEO_EXTS)
    inp = args.input
    if os.path.isdir(inp) and out_is_file:
        p.error("--output must be a directory for a folder input")
    if out_is_file:
        parent = os.path.dirname(args.output)
        if parent:
            os.makedirs(parent, exist_ok=True)
    else:
        os.makedirs(args.output, exist_ok=True)

    if os.path.isdir(inp):
        for f in sorted(os.listdir(inp)):
            if f.lower().endswith(IMAGE_EXTS):
                infer_image(run, os.path.join(inp, f), os.path.join(args.output, f),
                            args.thresh)
    elif inp.lower().endswith(VIDEO_EXTS):
        infer_video(run, inp, args.output if out_is_file
                    else os.path.join(args.output, "out.mp4"), args.thresh)
    else:
        infer_image(run, inp, args.output if out_is_file
                    else os.path.join(args.output, os.path.basename(inp)), args.thresh)


if __name__ == "__main__":
    main()
