"""OKS-aware contrastive denoising (CDN) queries: host-side, static shapes.

An own copy of ``detrpose_tpu/train/cdn.py`` (numpy; the port imports nothing
of the JAX package), plus ``cdn_to_device``, which moves its output to torch
tensors on a device. Reference semantics: src/models/detrpose/
dn_component.py:39-183. Positive and negative noised copies of each GT pose
are packed into groups; the noise magnitude is drawn per keypoint from the
COCO sigmas and the instance area, larger for negatives; an attention mask
blocks DN groups from each other and from the real queries.

Everything is emitted at a static capacity ``pad_cap`` with a validity mask.
Unused slots are blocked from all attention and masked out of the losses.
The embedding lookups stay in the model (``models/transformer.py``) so
``label_enc`` / ``pose_enc`` get gradients. The reference's oddities are kept
on purpose: the p=-1 normalisation of the noise direction, label flips drawn
from [0, 80), and the centre slot ``(boxes[:, :2] + boxes[:, 2:]) / 2`` on
cxcywh boxes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..constants import keypoint_sigmas
from ..parallel.dist import all_reduce_counts
from ..utils.device import resolve_device


def _inverse_sigmoid_np(x, eps=1e-3):
    x = np.clip(x, 0.0, 1.0)
    return np.log(np.clip(x, eps, None) / np.clip(1.0 - x, eps, None))


@dataclasses.dataclass
class CDNConfig:
    dn_number: int = 20          # reference dn_args=(targets, 20, 0.5)
    label_noise_ratio: float = 0.5
    # Label-noise flips draw uniformly from [0, label_flip_range). The
    # reference hard-codes num_classes=80 in its prepare_for_cdn call
    # (transformer.py:1271) even though the classification head has 2 classes,
    # and label_enc is an 81-row embedding (transformer.py:1057) — so most
    # flipped DN queries land on one of 78 otherwise-untrained embedding rows.
    # Intentional or not, the zoo checkpoints were trained with this
    # distribution, so 80 is the fidelity default.
    label_flip_range: int = 80
    pad_cap: int = 64            # static DN slot capacity
    match_cap: int = 32          # static positive-match capacity


def _ref_normalize_pm1(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Reproduce torch F.normalize(v, -1) — i.e. p=-1 along dim=1 — exactly.

    The reference intends a unit direction vector (dn_component.py:121-122
    "||rand_vector|| = 1") but `F.normalize(rand_vector, -1)` binds -1 to the
    *p* argument (dim stays at its default 1), so each (instance, coord) slice
    is divided by the reciprocal-sum "norm" (sum_k 1/|v_k|)^-1 over the 1+K
    keypoint axis. The resulting vectors have heavy-tailed L2 norms (~64 mean
    for 1+17 slots) — the zoo checkpoints were trained with THIS noise scale,
    so we reproduce it bug-for-bug (like the center-coordinate bug below).
    """
    norm = np.sum(np.abs(v) ** -1.0, axis=1, keepdims=True) ** -1.0
    return v / np.maximum(norm, eps)


def _known_num(targets: Dict[str, np.ndarray], cfg: CDNConfig) -> np.ndarray:
    """The GTs of each image that get noised copies (B,): at most pad_cap//2
    (one pos + one neg each must fit in a single group); extra GTs are still
    supervised by the main criterion, they just don't get DN queries."""
    return np.minimum(targets["valid"].astype(bool).sum(1), cfg.pad_cap // 2)


def known_max(targets: Dict[str, np.ndarray], cfg: Optional[CDNConfig] = None) -> int:
    """The largest GT count of the batch that ``build_cdn`` sizes its
    groups for (0: the batch gets no CDN block)."""
    known = _known_num(targets, cfg or CDNConfig())
    return int(known.max()) if known.size else 0


def build_cdn(
    targets: Dict[str, np.ndarray],
    num_queries: int,
    num_keypoints: int,
    img_hw,
    rng: np.random.Generator,
    cfg: Optional[CDNConfig] = None,
    max_known: Optional[int] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Build denoising queries for one batch.

    Args:
      targets: padded batch targets — labels (B, G), boxes (B, G, 4) cxcywh
        normalized, keypoints (B, G, 3K) xyxy..vv, area (B, G), valid (B, G).
      img_hw: (H, W) of the batch images.
      max_known: the GT count the group structure is sized for, at least
        this batch's ``known_max``; across data-parallel ranks the largest
        over the ranks, so every rank has the global batch's groups.

    Returns dict (or None if no GT in the batch):
      labels       (B, pad_cap) int32 — noised class ids for label_enc lookup
      pose_logits  (B, pad_cap, 1+K, 2) float32 — inverse-sigmoid noised poses
      attn_mask    (pad_cap+nq, pad_cap+nq) bool — True = blocked
      dn_match     {query_idx, gt_idx, valid (B, match_cap), num_group ()}
      pad_size, num_dn_group (python ints, static-capacity metadata)
    """
    cfg = cfg or CDNConfig()
    K = num_keypoints
    labels = targets["labels"]
    B, G = labels.shape
    known_num = _known_num(targets, cfg)
    if max_known is None:
        max_known = int(known_num.max()) if B else 0
    elif max_known < (int(known_num.max()) if B else 0):
        raise ValueError(f"build_cdn: max_known {max_known} is below the batch's "
                         f"{int(known_num.max())}")
    if max_known == 0:
        return None

    # group structure (dn_component.py:54-63): 2*dn_number total noised queries
    # split into groups of 2*max_known (pos+neg per GT).
    dn_number = cfg.dn_number * 2
    groups = dn_number // (max_known * 2)
    groups = max(groups, 1)
    single_pad = max_known
    # Shrink groups if capacity would overflow.
    while single_pad * 2 * groups > cfg.pad_cap and groups > 1:
        groups -= 1
    pad_size = single_pad * 2 * groups
    assert pad_size <= cfg.pad_cap, (pad_size, cfg.pad_cap)

    H, W = img_hw
    sig = np.concatenate([[0.1], keypoint_sigmas(K)])  # center prepended (:34)
    variances = (2.0 * sig) ** 2                        # (1+K,)

    out_labels = np.zeros((B, cfg.pad_cap), np.int32)
    out_pose = np.zeros((B, cfg.pad_cap, 1 + K, 2), np.float32)
    slot_used = np.zeros((B, cfg.pad_cap), bool)

    boxes = targets["boxes"]
    kpts = targets["keypoints"]
    areas = targets.get("area")

    for b in range(B):
        n = int(known_num[b])
        if n == 0:
            continue
        lab = labels[b, :n]
        # Reference bug reproduced bug-for-bug (dn_component.py:95-96): boxes
        # are cxcywh-normalized at this point (transforms.py Normalize
        # :287-290), yet the reference computes the noised "center" slot as
        # (boxes[:, :2] + boxes[:, 2:]) / 2 — i.e. ((cx+w)/2, (cy+h)/2), not
        # the true center. The zoo checkpoints were trained with this.
        ctr = (boxes[b, :n, :2] + boxes[b, :n, 2:]) / 2.0
        pose = kpts[b, :n, : 2 * K].reshape(n, K, 2)
        vis = kpts[b, :n, 2 * K:]                      # (n, K)
        if areas is not None:
            area = areas[b, :n]
        else:
            area = boxes[b, :n, 2] * boxes[b, :n, 3] * 0.53
        area_px = area * H * W

        full_pose = np.concatenate([ctr[:, None], pose], axis=1)  # (n, 1+K, 2)
        nonviz = np.concatenate(
            [np.ones((n, 1), bool), vis == 0], axis=1)            # (n, 1+K)

        for g in range(groups):
            for sign in range(2):  # 0 = positive, 1 = negative
                # noise direction + OKS-calibrated magnitude (:120-128);
                # the "direction" is NOT unit length — see _ref_normalize_pm1
                vec = rng.random((n, 1 + K, 2)).astype(np.float32)
                vec = _ref_normalize_pm1(vec)
                if sign == 0:
                    alpha = rng.uniform(-np.log(1.0), -np.log(0.5), (n, 1 + K, 1))
                else:
                    alpha = rng.uniform(-np.log(0.5), -np.log(0.1), (n, 1 + K, 1))
                alpha = alpha * 2.0 * (area_px[:, None, None] + np.finfo(np.float32).eps)
                alpha = alpha * variances[None, :, None]
                alpha = np.sqrt(alpha) / max(H, W)
                alpha[nonviz] = 0.0
                noised = full_pose + (alpha * vec).astype(np.float32)

                lab_n = lab.copy()
                if cfg.label_noise_ratio > 0:
                    # dn_component.py:84-87: flip 25% of DN labels uniformly
                    # into [0, 80) — see CDNConfig.label_flip_range.
                    flip = rng.random(n) < cfg.label_noise_ratio * 0.5
                    lab_n[flip] = rng.integers(0, cfg.label_flip_range, flip.sum())

                base = g * 2 * single_pad + sign * single_pad
                out_labels[b, base:base + n] = lab_n
                out_pose[b, base:base + n] = _inverse_sigmoid_np(noised)
                slot_used[b, base:base + n] = True

    # attention mask (dn_component.py:155-167): True = blocked.
    tgt = cfg.pad_cap + num_queries
    attn = np.zeros((tgt, tgt), bool)
    attn[cfg.pad_cap:, :cfg.pad_cap] = True                # real can't see DN
    for g in range(groups):
        s, e = g * 2 * single_pad, (g + 1) * 2 * single_pad
        attn[s:e, :cfg.pad_cap] = True
        attn[s:e, s:e] = False                             # own group visible
    attn[pad_size:cfg.pad_cap, :] = True                   # unused slots see nothing
    attn[:, pad_size:cfg.pad_cap] = True                   # nothing sees unused
    # ... except themselves, so their attention rows stay well-defined.
    for i in range(pad_size, cfg.pad_cap):
        attn[i, i] = False

    # fabricated positive indices (criterion.py:389-402)
    mq = np.zeros((B, cfg.match_cap), np.int32)
    mg = np.zeros((B, cfg.match_cap), np.int32)
    mv = np.zeros((B, cfg.match_cap), bool)
    for b in range(B):
        n = int(known_num[b])
        k = 0
        for g in range(groups):
            for t in range(n):
                if k >= cfg.match_cap:
                    break
                mq[b, k] = g * 2 * single_pad + t
                mg[b, k] = t
                mv[b, k] = True
                k += 1
    # slots beyond pad_size are inert capacity padding: blocked in attention
    # and masked out of the DN losses (the reference has exactly pad_size slots).
    active = np.zeros((cfg.pad_cap,), bool)
    active[:pad_size] = True
    return {
        "labels": out_labels,
        "pose_logits": out_pose,
        # True where a slot holds a real noised GT; unused slots get ZERO
        # content embeddings (reference pads with zeros, dn_component.py:141-148
        # padding_label), not label_enc(0) — they leak into real DN queries
        # through in-group across-instance attention.
        "slot_used": slot_used,
        "attn_mask": attn,
        "pad_size": cfg.pad_cap,
        "num_dn_group": groups,
        "dn_match": {
            "query_idx": mq,
            "gt_idx": mg,
            "valid": mv,
            "num_group": np.float32(groups),
            "active_mask": active,
        },
    }


def batch_cdn(batch: Dict, device: torch.device | str = "cuda") -> Optional[Dict]:
    """The CDN block of a loader batch (None without one). With one process
    the loader built it; across ranks it left ``make_cdn``, which builds it
    here with the global batch's group count: the largest ``known_max``
    over the ranks (an all-reduce on ``device``), so every rank has the
    groups one process has under JAX and the DN normalisers agree."""
    if "make_cdn" not in batch:
        return batch.get("dn")
    local = torch.tensor([known_max(batch["targets"])], device=resolve_device(device))
    return batch["make_cdn"](max_known=int(all_reduce_counts(local, "max").item()))


def cdn_to_device(dn: Optional[Dict], device: torch.device | str = "cuda"
                  ) -> Optional[Dict]:
    """``build_cdn``'s output as torch tensors on ``device``: class ids and
    indices as int64, masks as bool, poses and ``num_group`` as float32; the
    two ints stay ints. None stays None."""
    if dn is None:
        return None
    dev = resolve_device(device)

    def move(v):
        v = np.asarray(v)
        if v.dtype == bool:
            return torch.from_numpy(v).to(dev)
        if np.issubdtype(v.dtype, np.integer):
            return torch.from_numpy(v.astype(np.int64)).to(dev)
        return torch.from_numpy(v.astype(np.float32)).to(dev)

    out = {k: (v if k in ("pad_size", "num_dn_group") else move(v))
           for k, v in dn.items() if k != "dn_match"}
    out["dn_match"] = {k: move(v) for k, v in dn["dn_match"].items()}
    return out
