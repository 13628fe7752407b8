"""Synthetic COCO-format keypoint sets: the drawn stick-figure images of the
overfit run (``tools/overfit.py``).

A copy of ``tests/synth_data.py`` (a package module does not import the
tests): ``make_tiny_coco`` writes the same annotations and the same pixels
for the same arguments, which ``tests/test_torch_overfit.py`` holds.
``draw=True, structured=True`` renders each pose as per-joint-coloured disks
and grey limbs on a noisy canvas, so the pixels carry the ground truth and a
detector can learn it.
"""
import json
import os

import numpy as np
from PIL import Image


def rand_pose(rng, cx, cy, K=17, spread=40):
    kp = np.zeros((K, 3))
    kp[:, 0] = cx + rng.uniform(-spread, spread, K)
    kp[:, 1] = cy + rng.uniform(-spread, spread, K)
    kp[:, 2] = 2
    return kp


# COCO-ordered 17-joint template in a unit body frame (y down), roughly
# anatomical so joint identity is recoverable from geometry alone — random
# scatter poses are only learnable by memorization (recorded: 512-image probe
# hit train AP 0.60 / held-out 0.00 on scatter poses).
_TEMPLATE_17 = np.array([
    (0.00, -1.00), (-0.08, -1.08), (0.08, -1.08), (-0.20, -1.02),
    (0.20, -1.02), (-0.36, -0.70), (0.36, -0.70), (-0.52, -0.30),
    (0.52, -0.30), (-0.58, 0.10), (0.58, 0.10), (-0.22, 0.00),
    (0.22, 0.00), (-0.26, 0.55), (0.26, 0.55), (-0.28, 1.05), (0.28, 1.05),
])


def structured_pose(rng, cx, cy, K=17, scale=None):
    """A template stick figure under a random similarity transform + jitter.

    Unlike rand_pose's uniform scatter, the geometry itself identifies each
    joint, so a detector can generalize to unseen layouts.
    """
    if K != 17:
        return rand_pose(rng, cx, cy, K, 30)
    s = rng.uniform(20, 34) if scale is None else scale
    rot = rng.uniform(-0.45, 0.45)
    pts = _TEMPLATE_17 * s
    if rng.random() < 0.5:  # viewed from behind: mirror left/right
        pts = pts * np.array([-1.0, 1.0])
    c, sn = np.cos(rot), np.sin(rot)
    pts = pts @ np.array([[c, -sn], [sn, c]]).T
    pts = pts + rng.uniform(-2.0, 2.0, pts.shape)
    kp = np.zeros((K, 3))
    kp[:, 0] = cx + pts[:, 0]
    kp[:, 1] = cy + pts[:, 1]
    kp[:, 2] = 2
    return kp


_LIMBS_17 = [(15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
             (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
             (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6)]


def _joint_palette(K):
    """One distinct, fixed color PER JOINT INDEX (identical across persons
    and images) so joint identity is visually learnable — poses here are
    anatomically random, so without per-joint colors "which disk is keypoint
    k" would be unlearnable and held-out AP honestly zero."""
    cols = []
    for k in range(K):
        hue = k / K
        i = int(hue * 6)
        f = hue * 6 - i
        p, q, t = 40, int(40 + 215 * (1 - f)), int(40 + 215 * f)
        rgb = [(255, t, p), (q, 255, p), (p, 255, t),
               (p, q, 255), (t, p, 255), (255, p, q)][i % 6]
        cols.append(rgb)
    return cols


def _draw_people(rng, w, h, poses):
    """Render poses visibly (per-joint-colored disks + gray limb lines) on a
    noisy gray canvas, so pixels CORRELATE with the GT — a learnable
    detection task rather than pure memorization."""
    from PIL import ImageDraw

    canvas = rng.integers(96, 160, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(canvas)
    d = ImageDraw.Draw(img)
    for kp in poses:
        if kp.shape[0] == 17:
            for a, b in _LIMBS_17:
                d.line([tuple(kp[a, :2]), tuple(kp[b, :2])],
                       fill=(210, 210, 210), width=2)
    palette = _joint_palette(poses[0].shape[0]) if poses else []
    for kp in poses:
        for k, (x, y, _) in enumerate(kp):
            c = palette[k]
            d.ellipse([x - 3, y - 3, x + 3, y + 3], fill=c)
    return img


def make_tiny_coco(root, n_images=6, K=17, w=320, h=240, people=2, seed=0,
                   draw=False, structured=False):
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    aid = 1
    for i in range(n_images):
        if draw:
            poses = []
            m = min(60, w // 4)  # at 160px a fixed 60 pins everyone mid-frame
            for j in range(people):
                mk = structured_pose if structured else (
                    lambda r, x, y, k: rand_pose(r, x, y, k, 30))
                kp = mk(rng, rng.uniform(m, w - m),
                        rng.uniform(m, h - m), K)
                kp[:, 0] = kp[:, 0].clip(0, w - 1)
                kp[:, 1] = kp[:, 1].clip(0, h - 1)
                poses.append(kp)
            _draw_people(rng, w, h, poses).save(
                os.path.join(img_dir, f"{i:04d}.jpg"), quality=95)
            for kp in poses:
                xs, ys = kp[:, 0], kp[:, 1]
                annotations.append({
                    "id": aid, "image_id": i, "category_id": 1,
                    "keypoints": kp.reshape(-1).tolist(),
                    "num_keypoints": K, "iscrowd": 0,
                    "bbox": [float(xs.min()), float(ys.min()),
                             float(xs.max() - xs.min()),
                             float(ys.max() - ys.min())],
                    "area": float((xs.max() - xs.min()) * (ys.max() - ys.min())),
                })
                aid += 1
            images.append({"id": i, "file_name": f"{i:04d}.jpg",
                           "width": w, "height": h})
            continue
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f"{i:04d}.jpg"))
        images.append({"id": i, "file_name": f"{i:04d}.jpg", "width": w, "height": h})
        for j in range(people):
            kp = rand_pose(rng, 80 + 100 * j, 120, K, 30)
            kp[:, 0] = kp[:, 0].clip(0, w - 1)
            kp[:, 1] = kp[:, 1].clip(0, h - 1)
            xs, ys = kp[:, 0], kp[:, 1]
            annotations.append({
                "id": aid, "image_id": i, "category_id": 1,
                "keypoints": kp.reshape(-1).tolist(),
                "num_keypoints": K, "iscrowd": 0,
                "bbox": [float(xs.min()), float(ys.min()),
                         float(xs.max() - xs.min()), float(ys.max() - ys.min())],
                "area": float((xs.max() - xs.min()) * (ys.max() - ys.min())),
            })
            aid += 1
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann_file
