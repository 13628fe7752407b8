"""Self-contained COCO-style keypoint evaluator (OKS AP/AR), numpy.

An own copy of ``detrpose_tpu/data/evaluator.py`` (the port imports nothing
of the JAX package). Reimplements the COCOeval 'keypoints' protocol used by
the reference (src/data/coco_eval.py via pycocotools, src/data/
crowdpose_eval.py via xtcocotools) without external deps:

  * per-image OKS between detections and GTs (gaussian falloff with
    per-keypoint sigmas, normalized by instance area; vis>0 keypoints only)
  * greedy matching per OKS threshold in score order, crowd/ignore handling;
    the match runs natively (``csrc/coco_match.cc`` through
    ``utils/native.py``) where it builds, else as the Python loop below
  * PR accumulation over 101 recall points, areaRng splits, maxDets=20
  * summarize: AP, AP50, AP75, AP-M, AP-L, AR, AR50, ...

CrowdPose mode (`use_area=False`, 14 keypoints) normalizes OKS by the GT box
area like xtcocotools and adds AP-easy/medium/hard splits by image crowdIndex
(in that mode `AP_medium` is the crowd-medium split, matching the CrowdPose
protocol which has no area splits).

Evaluators of parts of a split are joined with `merge()` before
`accumulate()` (reference: coco_eval.py:93-105).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import keypoint_sigmas


def compute_oks(det_kpts, gt_kpts, gt_areas, sigmas, use_area=True, gt_boxes=None):
    """OKS matrix (n_det, n_gt).

    det_kpts: (D, K, 3) x,y,score; gt_kpts: (G, K, 3) x,y,vis; gt_areas: (G,).
    """
    D, K, _ = det_kpts.shape
    G = gt_kpts.shape[0]
    ious = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return ious
    var = (sigmas * 2) ** 2  # (K,)

    if use_area:
        norms = np.asarray(gt_areas, np.float64)
    else:
        norms = gt_boxes[:, 2] * gt_boxes[:, 3] * 0.53
    norms = norms + np.spacing(1)

    # vectorized main case: gts with >= 1 visible keypoint
    vg = gt_kpts[:, :, 2] > 0                              # (G, K)
    dx = det_kpts[None, :, :, 0] - gt_kpts[:, None, :, 0]  # (G, D, K)
    dy = det_kpts[None, :, :, 1] - gt_kpts[:, None, :, 1]
    e = (dx**2 + dy**2) / var[None, None] / norms[:, None, None] / 2.0
    w = vg[:, None, :]
    nvis = np.maximum(vg.sum(1), 1)[:, None]               # (G, 1)
    oks = (np.exp(-e) * w).sum(-1) / nvis                  # (G, D)
    has_vis = vg.any(1)
    ious[:, has_vis] = oks[has_vis].T

    # fallback: gts with no visible keypoints -> distance to the expanded box
    # (COCOeval computeOks else-branch)
    for g in np.nonzero(~has_vis)[0]:
        if gt_boxes is None:
            continue
        box = gt_boxes[g]
        x0, y0 = box[0] - box[2], box[1] - box[3]
        x1, y1 = box[0] + box[2] * 2, box[1] + box[3] * 2
        xd, yd = det_kpts[:, :, 0], det_kpts[:, :, 1]      # (D, K)
        bdx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
        bdy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
        eb = (bdx**2 + bdy**2) / var[None] / norms[g] / 2.0
        ious[:, g] = np.exp(-eb).mean(1)
    return ious


class KeypointEvaluator:
    """Accumulates per-image detections; computes COCO keypoint AP/AR."""

    def __init__(
        self,
        gts: Dict[int, Dict],
        num_keypoints: int = 17,
        use_area: bool = True,
        crowd_index: Optional[Dict[int, float]] = None,
        use_native: bool = True,
    ):
        """
        Args:
          gts: image_id -> {"anns": list of {keypoints (K,3), area, bbox (x,y,w,h),
               iscrowd, num_keypoints}} ground truth.
          use_area: False for CrowdPose-style OKS normalization.
          crowd_index: image_id -> crowdIndex (CrowdPose easy/med/hard splits).
          use_native: match with the native library where it builds; False
               runs the Python loop. ``matched_by`` records which one ran
               ("native", "python", or None before any image was matched).
        """
        self.gts = gts
        self.K = num_keypoints
        self.sigmas = keypoint_sigmas(num_keypoints).astype(np.float64)
        self.use_area = use_area
        self.crowd_index = crowd_index
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = 20
        self.area_rngs = [
            ("all", [0, 1e10]),
            ("medium", [32**2, 96**2]),
            ("large", [96**2, 1e10]),
        ]
        self.dets: Dict[int, List] = {}
        self._iou_cache: Dict[int, np.ndarray] = {}
        self.use_native = use_native
        self.matched_by: Optional[str] = None

    def update(self, image_id: int, scores, keypoints):
        """Add detections for an image: scores (D,), keypoints (D, K, 3)."""
        self._iou_cache.clear()
        self.dets.setdefault(int(image_id), [])
        for s, k in zip(np.asarray(scores), np.asarray(keypoints)):
            # detection area = keypoint bbox area (pycocotools loadRes for
            # keypoint results), used for area-range ignore below
            xs, ys = k[:, 0], k[:, 1]
            area = float((xs.max() - xs.min()) * (ys.max() - ys.min()))
            self.dets[int(image_id)].append(
                {"score": float(s), "keypoints": k, "area": area})

    def merge(self, others: Sequence["KeypointEvaluator"]):
        self._iou_cache.clear()
        for o in others:
            for img, d in o.dets.items():
                self.dets.setdefault(img, []).extend(d)

    # -- evaluation core ---------------------------------------------------
    def _img_ious(self, img_id, gt, dt):
        """OKS matrix in ORIGINAL gt order; cached — it is independent of the
        area range, which previously recomputed it 3x per image."""
        key = img_id
        cached = self._iou_cache.get(key)
        if cached is not None:
            return cached
        if len(gt) and len(dt):
            det_k = np.stack([d["keypoints"] for d in dt])
            gt_k = np.stack([g["keypoints"] for g in gt]).astype(np.float64)
            areas = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gt])
            boxes = np.stack([np.asarray(g["bbox"], np.float64) for g in gt])
            ious = compute_oks(det_k.astype(np.float64), gt_k, areas, self.sigmas,
                               self.use_area, boxes)
        else:
            ious = np.zeros((len(dt), len(gt)))
        self._iou_cache[key] = ious
        return ious

    def _evaluate_img(self, img_id, area_rng):
        gt = self.gts.get(img_id, {"anns": []})["anns"]
        dt = sorted(self.dets.get(img_id, []), key=lambda d: -d["score"])[: self.max_dets]
        if len(gt) == 0 and len(dt) == 0:
            return None
        T = len(self.iou_thrs)
        ious_orig = self._img_ious(img_id, gt, dt)

        gt_ignore = []
        for g in gt:
            ig = g.get("iscrowd", 0) or g.get("num_keypoints", self.K) == 0
            area = g.get("area", g["bbox"][2] * g["bbox"][3])
            if area < area_rng[0] or area > area_rng[1]:
                ig = True
            gt_ignore.append(bool(ig))
        order = np.argsort([int(i) for i in gt_ignore], kind="stable")
        gt = [gt[i] for i in order]
        # dtype=bool matters: an image with detections but zero GTs would
        # otherwise produce a float64 empty array and break ~gt_ignore
        gt_ignore = np.asarray([gt_ignore[i] for i in order], dtype=bool)
        gt_iscrowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gt])
        ious = ious_orig[:, order] if len(gt) else ious_orig

        G, D = len(gt), len(dt)
        gtm = -np.ones((T, G), np.int64)
        dtm = -np.ones((T, D), np.int64)
        dt_ignore_u8 = np.zeros((T, D), np.uint8)
        # imported here: the loader's worker processes import this package
        # and must not pay ``utils``'s torch import
        from ..utils.native import match_image_native

        native = bool(D and G and self.use_native and match_image_native(
            ious, self.iou_thrs, gt_ignore, gt_iscrowd, gtm, dtm, dt_ignore_u8))
        if D and G:
            self.matched_by = "native" if native else "python"
        if not native:
            # the Python loop (identical semantics to csrc/coco_match.cc)
            for t, thr in enumerate(self.iou_thrs):
                for d in range(D):
                    iou = min(thr, 1 - 1e-10)
                    m = -1
                    for g in range(G):
                        # already-matched gts can only be re-matched if iscrowd
                        # (pycocotools evaluateImg)
                        if gtm[t, g] >= 0 and not gt_iscrowd[g]:
                            continue
                        if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                            break  # past matchable non-ignore gts
                        if ious[d, g] < iou:
                            continue
                        iou = ious[d, g]
                        m = g
                    if m == -1:
                        continue
                    dtm[t, d] = m
                    gtm[t, m] = d
                    dt_ignore_u8[t, d] = gt_ignore[m]
        dt_ignore = dt_ignore_u8.astype(bool)
        # unmatched detections whose own area is outside the range are ignored
        # in that split (pycocotools: dtIg |= (dtm==0) & (d area outside aRng))
        if D:
            d_area = np.asarray([d.get("area", 0.0) for d in dt])
            out_rng = (d_area < area_rng[0]) | (d_area > area_rng[1])
            dt_ignore |= (dtm < 0) & out_rng[None, :]
        return {
            "dt_scores": np.asarray([d["score"] for d in dt]),
            "dtm": dtm,
            "dt_ignore": dt_ignore,
            "gt_ignore": gt_ignore,
            "num_gt": int((~gt_ignore).sum()),
        }

    def accumulate(self):
        img_ids = sorted(self.gts.keys())
        self._accumulate_for(img_ids)
        # CrowdPose easy/medium/hard splits by image crowdIndex
        # (xtcocotools iou_type 'keypoints_crowd').
        self.crowd_stats = {}
        if self.crowd_index is not None:
            splits = {
                "easy": [i for i in img_ids if self.crowd_index.get(i, 0) <= 0.1],
                "medium": [i for i in img_ids
                           if 0.1 < self.crowd_index.get(i, 0) <= 0.8],
                "hard": [i for i in img_ids if self.crowd_index.get(i, 0) > 0.8],
            }
            main_p, main_r = self.precision, self.recall
            for name, ids in splits.items():
                if not ids:
                    self.crowd_stats[f"AP_{name}"] = -1.0
                    continue
                self._accumulate_for(ids)
                x = self.precision[:, :, 0]
                x = x[x > -1]
                self.crowd_stats[f"AP_{name}"] = float(x.mean()) if x.size else -1.0
            self.precision, self.recall = main_p, main_r
        return self.precision, self.recall

    def _accumulate_for(self, img_ids):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        A = len(self.area_rngs)
        precision = -np.ones((T, R, A))
        recall = -np.ones((T, A))

        for a, (_, rng) in enumerate(self.area_rngs):
            evals = [self._evaluate_img(i, rng) for i in img_ids]
            evals = [e for e in evals if e is not None]
            if not evals:
                continue
            scores = np.concatenate([e["dt_scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            dtm = np.concatenate([e["dtm"] for e in evals], axis=1)[:, order]
            dtig = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]
            npig = sum(e["num_gt"] for e in evals)
            if npig == 0:
                continue
            tps = (dtm >= 0) & ~dtig
            fps = (dtm < 0) & ~dtig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_sum[t], fp_sum[t]
                rc = tp / npig
                pr = tp / (tp + fp + np.spacing(1))
                recall[t, a] = rc[-1] if len(rc) else 0
                # precision envelope
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, self.rec_thrs, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[t, :, a] = q
        self.precision = precision
        self.recall = recall
        return precision, recall

    def summarize(self) -> Dict[str, float]:
        p, r = self.precision, self.recall

        def ap(t=None, a=0):
            x = p[:, :, a] if t is None else p[t:t + 1, :, a]
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        def ar(t=None, a=0):
            x = r[:, a] if t is None else r[t:t + 1, a]
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        stats = {
            "AP": ap(), "AP50": ap(t=0), "AP75": ap(t=5),
            "AP_medium": ap(a=1), "AP_large": ap(a=2),
            "AR": ar(), "AR50": ar(t=0), "AR75": ar(t=5),
            "AR_medium": ar(a=1), "AR_large": ar(a=2),
        }
        stats.update(getattr(self, "crowd_stats", {}))
        return stats
