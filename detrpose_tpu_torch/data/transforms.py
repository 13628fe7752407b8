"""Keypoint-aware data augmentations (host-side, numpy + PIL).

An own copy of ``detrpose_tpu/data/transforms.py``: the same PIL operations
and the same ``random.Random`` draws in the same order, so a seed gives the
same image bytes and targets.

Reference semantics: src/data/transforms.py (COCO 17-kpt flip pairs :77-101,
crop visibility zeroing :47-73, zoom-out padding :195-208, random box crop
:211-231, mosaic :314-389, epoch-policy container src/data/container.py).

All transforms are functions (image, target) -> (image, target) operating in
pixel space; `Normalize`-equivalent conversion to the network layout happens in
data/coco.normalize_target at batch assembly.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance

FLIP_PAIRS_17 = [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16)]
FLIP_PAIRS_14 = [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11)]


def hflip(img: Image.Image, target: Dict, num_keypoints: int = 17):
    """Horizontal flip with left/right keypoint swapping (transforms.py:77-101)."""
    w, _ = img.size
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    t = dict(target)
    boxes = t["boxes"].copy()
    if len(boxes):
        boxes = boxes[:, [2, 1, 0, 3]] * np.asarray([-1, 1, -1, 1]) + np.asarray([w, 0, w, 0])
        t["boxes"] = boxes.astype(np.float32)
    kp = t["keypoints"].copy()
    if len(kp):
        kp[:, :, 0] = w - kp[:, :, 0] - 1  # reference: transforms.py:94 (w - x - 1)
        kp[kp[:, :, 2] == 0] = 0  # unannotated stay zero
        pairs = FLIP_PAIRS_17 if num_keypoints == 17 else FLIP_PAIRS_14
        for a, b in pairs:
            kp[:, [a, b]] = kp[:, [b, a]]
        t["keypoints"] = kp
    return img, t


def resize_shorter(img: Image.Image, target: Dict, size: int,
                   max_size: int | None = None):
    """Aspect-preserving resize: shorter side -> `size`, optionally capped so
    the longer side stays <= max_size (reference transforms.py:104-165,
    including the int() truncation of the scaled long side)."""
    w, h = img.size
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        ow, oh = w, h
    elif w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return resize(img, target, (ow, oh))


def resize(img: Image.Image, target: Dict, size: Tuple[int, int]):
    """Resize to exact (w, h)."""
    w0, h0 = img.size
    w1, h1 = size
    img = img.resize((w1, h1), Image.BILINEAR)
    sx, sy = w1 / w0, h1 / h0
    t = dict(target)
    if len(t["boxes"]):
        t["boxes"] = (t["boxes"] * np.asarray([sx, sy, sx, sy])).astype(np.float32)
    if len(t["keypoints"]):
        kp = t["keypoints"].copy()
        kp[:, :, 0] *= sx
        kp[:, :, 1] *= sy
        t["keypoints"] = kp
    t["area"] = (t["area"] * sx * sy).astype(np.float32)
    t["size"] = np.asarray([h1, w1], np.float32)
    return img, t


def random_zoom_out(img: Image.Image, target: Dict, rng: random.Random,
                    side_range: Tuple[float, float] = (1.0, 2.5), fill=0):
    """Zoom out by SYMMETRIC padding (reference transforms.py:195-208 + pad
    :168-192): ratio ~ U(side_range), pad_w = int((ratio-1)*w) on BOTH left and
    right (likewise pad_h top/bottom), so the image is centered on a canvas up
    to ~4x per axis, fill 0. Keypoints shift only where visible (pad zeroes
    v==0 rows, :183)."""
    w, h = img.size
    r = rng.uniform(side_range[0], side_range[1])
    pad_w = int((r - 1.0) * w)
    pad_h = int((r - 1.0) * h)
    canvas = Image.new("RGB", (w + 2 * pad_w, h + 2 * pad_h), fill)
    canvas.paste(img, (pad_w, pad_h))
    t = dict(target)
    if len(t["boxes"]):
        t["boxes"] = (t["boxes"] + np.asarray(
            [pad_w, pad_h, pad_w, pad_h])).astype(np.float32)
    if len(t["keypoints"]):
        kp = t["keypoints"].copy()
        vis = kp[:, :, 2] > 0
        kp[:, :, 0] += pad_w * vis
        kp[:, :, 1] += pad_h * vis
        t["keypoints"] = kp
    t["size"] = np.asarray([h + 2 * pad_h, w + 2 * pad_w], np.float32)
    return canvas, t


def random_crop(img: Image.Image, target: Dict, rng: random.Random,
                crop_mode: str = "zero"):
    """Crop to a random GT box region (transforms.py:211-231).

    NOTE: no *shipped* reference config instantiates RandomCrop (the policy
    lists the name, but neither include/dataset.py nor
    include/dataset_crowdpose.py put one in the transform stack) — this is a
    capability-parity op, off by default in TrainTransforms.

    crop_mode:
      "zero"  — COCO semantics (src/data/transforms.py:47-73): out-of-crop
                keypoints get visibility 0 and instances left with no visible
                keypoints are dropped.
      "clamp" — CrowdPose semantics (src/data/transforms_crowdpose.py:57-66):
                keypoints are clamped to the crop border, visibility is kept,
                and instances are dropped only when their cropped box has zero
                area (:44-55).
    """
    if len(target["boxes"]) == 0:
        return img, target
    i = rng.randrange(len(target["boxes"]))
    x0, y0, x1, y1 = target["boxes"][i]
    w, h = img.size
    x0, y0 = int(max(0, x0)), int(max(0, y0))
    x1, y1 = int(min(w, x1)), int(min(h, y1))
    if x1 - x0 < 8 or y1 - y0 < 8:
        return img, target
    return crop(img, target, (x0, y0, x1 - x0, y1 - y0), crop_mode)


def crop(img: Image.Image, target: Dict, region: Tuple[int, int, int, int],
         crop_mode: str = "zero"):
    """Crop to region (x0, y0, w, h); see random_crop for mode semantics.

    Golden-tested against the reference's crop functions
    (tests/test_transforms_golden.py): "zero" vs src/data/transforms.py:44-73,
    "clamp" vs src/data/transforms_crowdpose.py:16-67.
    """
    x0, y0, cw, ch = region
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    t = dict(target)
    boxes = t["boxes"] - np.asarray([x0, y0, x0, y0], np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    kp = t["keypoints"].copy()
    if crop_mode == "clamp":
        # CrowdPose: shift, clamp to the crop, keep visibility; drop only
        # zero-area boxes; area recomputed from the cropped box
        # (transforms_crowdpose.py:26-66)
        if len(kp):
            kp[:, :, 0] = (kp[:, :, 0] - x0).clip(0, cw)
            kp[:, :, 1] = (kp[:, :, 1] - y0).clip(0, ch)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        area = ((boxes[:, 2] - boxes[:, 0])
                * (boxes[:, 3] - boxes[:, 1])).astype(np.float32)
    else:
        # COCO: zero visibility outside the crop; drop instances left with no
        # visible keypoints (transforms.py:44-73); area kept as-is (:59-62
        # recomputes box area only into 'area' for boxes — matched below)
        keep = np.ones(len(boxes), bool)
        area = ((boxes[:, 2] - boxes[:, 0])
                * (boxes[:, 3] - boxes[:, 1])).astype(np.float32)
        if len(kp):
            kp[:, :, 0] -= x0
            kp[:, :, 1] -= y0
            # inclusive bounds: 0 <= x <= w (transforms.py:54-59)
            inside = ((kp[:, :, 0] >= 0) & (kp[:, :, 0] <= cw)
                      & (kp[:, :, 1] >= 0) & (kp[:, :, 1] <= ch))
            kp[:, :, 2] = kp[:, :, 2] * inside
            kp[kp[:, :, 2] == 0] = 0
            keep = kp[:, :, 2].sum(1) > 0
    t["boxes"] = boxes[keep].astype(np.float32)
    t["keypoints"] = kp[keep] if len(kp) else kp
    t["labels"] = t["labels"][keep]
    t["area"] = np.asarray(area)[keep]
    return img, t


def adjust_hue(img: Image.Image, hue_factor: float) -> Image.Image:
    """Hue shift via uint8 HSV wraparound — torchvision's PIL adjust_hue
    semantics (the backend the reference's ColorJitter uses on PIL inputs,
    transforms.py:439-442); golden vs colorsys in tests."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    if img.mode in {"L", "1", "I", "F"}:
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    # uint8 wraparound add (torchvision does np.uint8(hue_factor * 255) +=,
    # relying on numpy-1 overflow wrapping; numpy>=2 raises, so wrap explicitly)
    shift = np.uint8(int(hue_factor * 255) & 0xFF)
    with np.errstate(over="ignore"):
        np_h += shift
    h = Image.fromarray(np_h, "L")
    return Image.merge("HSV", (h, s, v)).convert(img.mode)


def sample_jitter_params(rng: random.Random, brightness=0.4, contrast=0.4,
                         saturation=0.4, hue=0.4, p=0.5):
    """The reference ColorJitter's sampling protocol (transforms.py:391-443):
    with probability p, all four ops fire in a RANDOM order, factors
    brightness/contrast/saturation ~ U(1-m, 1+m), hue ~ U(-hue, +hue).
    Returns [] when the whole jitter is skipped."""
    if rng.random() >= p:
        return []
    ops = [("brightness", 1 - brightness, 1 + brightness),
           ("contrast", 1 - contrast, 1 + contrast),
           ("saturation", 1 - saturation, 1 + saturation),
           ("hue", -hue, hue)]
    order = list(range(4))
    rng.shuffle(order)  # torch.randperm(4) equivalent (:424)
    return [(ops[i][0], rng.uniform(ops[i][1], ops[i][2])) for i in order]


_JITTER_APPLY = {
    "brightness": lambda img, f: ImageEnhance.Brightness(img).enhance(f),
    "contrast": lambda img, f: ImageEnhance.Contrast(img).enhance(f),
    "saturation": lambda img, f: ImageEnhance.Color(img).enhance(f),
    "hue": adjust_hue,
}


def color_jitter(img: Image.Image, rng: random.Random, brightness=0.4,
                 contrast=0.4, saturation=0.4, hue=0.4, p=0.5):
    """Reference ColorJitter (transforms.py:391-443): brightness/contrast/
    saturation AND hue (0.4 each), all-or-nothing with probability p, random
    op order. PIL backends match torchvision's PIL paths (ImageEnhance +
    HSV-uint8 hue)."""
    for name, f in sample_jitter_params(rng, brightness, contrast,
                                        saturation, hue, p):
        img = _JITTER_APPLY[name](img, f)
    return img


def mosaic(dataset, idx: int, rng: random.Random, cell_size: int = 320,
           num_keypoints: int = 17, sample_ids: Sequence[int] | None = None):
    """2x2 mosaic of 4 samples (reference transforms.py:314-389).

    Each sample is resized ASPECT-PRESERVING to shorter side `cell_size`
    (RandomResize(sizes=[320]), :318), then pasted at the corner offsets
    [0,0], [max_w,0], [0,max_h], [max_w,max_h] of a 2*max_w x 2*max_h black
    canvas (:347-351); keypoints shift only where visible (:361).
    `sample_ids` overrides the 3 random partner indices (for golden tests).
    """
    if sample_ids is None:
        sample_ids = [rng.randrange(len(dataset)) for _ in range(3)]
    imgs, tgts = [], []
    max_w = max_h = 0
    for sid in [idx] + list(sample_ids):
        img, t = dataset.load_raw(sid)
        img, t = resize_shorter(img, t, cell_size)
        max_w, max_h = max(max_w, img.size[0]), max(max_h, img.size[1])
        imgs.append(img)
        tgts.append(t)
    offsets = [(0, 0), (max_w, 0), (0, max_h), (max_w, max_h)]
    canvas = Image.new("RGB", (max_w * 2, max_h * 2), 0)
    K = num_keypoints
    all_t: Dict[str, List] = {"boxes": [], "labels": [], "keypoints": [], "area": []}
    for (ox, oy), img, t in zip(offsets, imgs, tgts):
        canvas.paste(img, (ox, oy))
        if len(t["boxes"]):
            all_t["boxes"].append(t["boxes"] + np.asarray([ox, oy, ox, oy], np.float32))
            all_t["labels"].append(t["labels"])
            kp = t["keypoints"].copy()
            vis = kp[:, :, 2] > 0
            kp[:, :, 0] += ox * vis
            kp[:, :, 1] += oy * vis
            all_t["keypoints"].append(kp)
            all_t["area"].append(t["area"])
    target = {
        "image_id": tgts[0]["image_id"],
        "orig_size": np.asarray([max_h * 2, max_w * 2], np.float32),
        "size": np.asarray([max_h * 2, max_w * 2], np.float32),
        "boxes": (np.concatenate(all_t["boxes"]) if all_t["boxes"]
                  else np.zeros((0, 4), np.float32)),
        "labels": (np.concatenate(all_t["labels"]) if all_t["labels"]
                   else np.zeros((0,), np.int32)),
        "keypoints": (np.concatenate(all_t["keypoints"]) if all_t["keypoints"]
                      else np.zeros((0, K, 3), np.float32)),
        "area": (np.concatenate(all_t["area"]) if all_t["area"]
                 else np.zeros((0,), np.float32)),
    }
    return canvas, target


class TrainTransforms:
    """Epoch-aware augmentation policy (reference: src/data/container.py).

    policy_epochs = (mosaic_until_warmup, aug_stop_1, aug_stop_2): mosaic and
    crop/zoom-out are mutually exclusive per sample; all heavy augs switch off
    after the policy window, mirroring `stop_epoch` behavior.
    """

    def __init__(self, out_size: int = 640, num_keypoints: int = 17,
                 policy_epochs: Sequence[int] = (5, 29, 48), seed: int = 0,
                 use_mosaic: bool = True, mosaic_prob: float = 0.5,
                 use_crop: bool = False, crop_prob: float = 0.8,
                 crop_mode: str = "zero"):
        self.out_size = out_size
        self.K = num_keypoints
        self.policy_epochs = policy_epochs
        self.epoch = 0
        self.rng = random.Random(seed)
        self.use_mosaic = use_mosaic
        self.mosaic_prob = mosaic_prob
        # No shipped reference config crops (see random_crop docstring);
        # use_crop exists for capability parity with the RandomCrop /
        # transforms_crowdpose.crop classes.
        self.use_crop = use_crop
        self.crop_prob = crop_prob
        self.crop_mode = crop_mode

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __call__(self, img, target, dataset=None, index=None):
        rng = self.rng
        e = self.epoch
        p0, p1, p2 = self.policy_epochs
        heavy_on = p0 <= e < p2

        # container.py:44-63: mosaic is rolled (prob mosaic_prob) only inside
        # [p0, p1); when it fires, ZoomOut/Crop are skipped for this sample.
        with_mosaic = (heavy_on and e < p1 and self.use_mosaic
                       and dataset is not None and index is not None
                       and rng.random() <= self.mosaic_prob)
        if with_mosaic:
            img, target = mosaic(dataset, index, rng,
                                 cell_size=self.out_size // 2,
                                 num_keypoints=self.K)
        elif heavy_on:
            if rng.random() < 0.5:  # RandomZoomOut internal p (dataset.py:34)
                img, target = random_zoom_out(img, target, rng)
            if self.use_crop and rng.random() < self.crop_prob:
                img, target = random_crop(img, target, rng, self.crop_mode)

        if rng.random() < 0.5:
            img, target = hflip(img, target, self.K)
        img = color_jitter(img, rng)
        img, target = resize(img, target, (self.out_size, self.out_size))
        return img, target


class EvalTransforms:
    """Deterministic eval path: resize to the eval resolution."""

    def __init__(self, out_size: int = 640):
        self.out_size = out_size

    def __call__(self, img, target, dataset=None, index=None):
        return resize(img, target, (self.out_size, self.out_size))
