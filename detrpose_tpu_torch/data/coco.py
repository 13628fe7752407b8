"""COCO / CrowdPose keypoint datasets — self-contained JSON parsing (no
pycocotools dependency).

An own copy of ``detrpose_tpu/data/coco.py`` (numpy and PIL, as there, so the
targets and image bytes agree bit for bit).

Reference semantics: src/data/coco.py (train filtering of zero-keypoint images
:31-41, target construction :91-141) and src/data/crowdpose.py. Targets use the
reference's normalized layout (src/data/transforms.py:276-311): boxes cxcywh
normalized, keypoints as interleaved xy pairs (2K, normalized) followed by K
visibilities, area normalized by image area.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


class CocoKeypointDataset:
    """Keypoint detection dataset over a COCO-format annotation file."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        num_keypoints: int = 17,
        train: bool = False,
        transforms=None,
    ):
        self.img_folder = img_folder
        self.num_keypoints = num_keypoints
        self.train = train
        self.transforms = transforms

        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        # CrowdPose images carry a crowdIndex used for AP-easy/medium/hard.
        self.crowd_index = {
            im["id"]: im["crowdIndex"] for im in coco["images"] if "crowdIndex" in im
        } or None
        self.anns_by_img: Dict[int, List[dict]] = {}
        for ann in coco.get("annotations", []):
            if ann.get("category_id", 1) != 1 and not self._person_cat(coco, ann):
                continue
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)

        ids = sorted(self.images.keys())
        if train:
            # keep only images with >= 1 instance with annotated keypoints
            # (reference: coco.py:31-41)
            def has_kpts(i):
                return any(
                    a.get("num_keypoints", 0) > 0 and not a.get("iscrowd", 0)
                    for a in self.anns_by_img.get(i, [])
                )
            ids = [i for i in ids if has_kpts(i)]
        self.ids = ids

    @staticmethod
    def _person_cat(coco, ann):
        cats = {c["id"]: c for c in coco.get("categories", [])}
        c = cats.get(ann.get("category_id"))
        return c is not None and c.get("name") == "person"

    def __len__(self):
        return len(self.ids)

    def load_raw(self, idx: int):
        """Returns (PIL image RGB, target dict in *pixel* coords)."""
        img_id = self.ids[idx]
        info = self.images[img_id]
        path = os.path.join(self.img_folder, info["file_name"])
        img = Image.open(path).convert("RGB")
        w, h = img.size

        K = self.num_keypoints
        anns = [a for a in self.anns_by_img.get(img_id, []) if not a.get("iscrowd", 0)]
        if self.train:
            anns = [a for a in anns if a.get("num_keypoints", 0) > 0]
        boxes, labels, kpts, areas = [], [], [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            x0, y0 = max(0.0, x), max(0.0, y)
            x1, y1 = min(w, x + bw), min(h, y + bh)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(0)
            kp = np.asarray(a.get("keypoints", [0] * (3 * K)), np.float32).reshape(K, 3)
            kpts.append(kp)
            areas.append(a.get("area", (x1 - x0) * (y1 - y0)))
        target = {
            "image_id": img_id,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32),
            "keypoints": (np.stack(kpts) if kpts
                          else np.zeros((0, K, 3), np.float32)),
            "area": np.asarray(areas, np.float32),
            "orig_size": np.asarray([w, h], np.float32),
            "size": np.asarray([h, w], np.float32),
        }
        return img, target

    def __getitem__(self, idx: int):
        img, target = self.load_raw(idx)
        if self.transforms is not None:
            img, target = self.transforms(img, target, dataset=self, index=idx)
        return img, target


def normalize_target(target: Dict, w: int, h: int, num_keypoints: int) -> Dict:
    """Pixel-space target -> reference normalized layout (transforms.py:276-311)."""
    K = num_keypoints
    boxes = target["boxes"].astype(np.float32)
    cxcywh = np.stack([
        (boxes[:, 0] + boxes[:, 2]) / 2 / w,
        (boxes[:, 1] + boxes[:, 3]) / 2 / h,
        (boxes[:, 2] - boxes[:, 0]) / w,
        (boxes[:, 3] - boxes[:, 1]) / h,
    ], -1) if len(boxes) else np.zeros((0, 4), np.float32)
    kp = target["keypoints"].astype(np.float32)  # (N, K, 3)
    if len(kp):
        z = kp[:, :, :2] / np.asarray([w, h], np.float32)
        v = (kp[:, :, 2] > 0).astype(np.float32)
        zv = np.concatenate([z.reshape(-1, 2 * K), v], -1)
    else:
        zv = np.zeros((0, 3 * K), np.float32)
    return {
        "image_id": target["image_id"],
        "boxes": cxcywh,
        "labels": target["labels"].astype(np.int32),
        "keypoints": zv,
        "area": target["area"].astype(np.float32) / (w * h),
        "orig_size": target["orig_size"],
    }


def pad_targets(targets: List[Dict], max_gt: int = 64) -> Dict[str, np.ndarray]:
    """Stack per-image normalized targets into padded batch arrays.

    max_gt=64 covers mosaic unions (4 images' targets);
    instances beyond the cap are dropped (rare at 64).
    """
    B = len(targets)
    K3 = targets[0]["keypoints"].shape[-1] if targets else 0
    out = {
        "labels": np.zeros((B, max_gt), np.int32),
        "boxes": np.zeros((B, max_gt, 4), np.float32),
        "keypoints": np.zeros((B, max_gt, K3), np.float32),
        "area": np.full((B, max_gt), 1.0, np.float32),
        "valid": np.zeros((B, max_gt), bool),
    }
    for b, t in enumerate(targets):
        n = min(len(t["labels"]), max_gt)
        out["labels"][b, :n] = t["labels"][:n]
        out["boxes"][b, :n] = t["boxes"][:n]
        out["keypoints"][b, :n] = t["keypoints"][:n]
        out["area"][b, :n] = np.maximum(t["area"][:n], 1e-8)
        out["valid"][b, :n] = True
    return out
