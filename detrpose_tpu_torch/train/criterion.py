"""Training criterion: Hungarian-matched VFL + L1 + OKS losses with deep
supervision, on batched and padded targets.

Counterpart of ``detrpose_tpu/train/criterion.py``; reference semantics:
src/models/detrpose/criterion.py.
  * ``loss_vfl`` (criterion.py:58-93): varifocal BCE whose positive target is
    the detached OKS of the matched prediction.
  * ``loss_keypoints`` (criterion.py:200-229): visibility-masked L1 + (1 - OKS)
    at the union ("go") matching across all decoder layers (:247-268).
  * per-branch matching for the class losses, the union matching for the
    keypoints, and the denoising (DN) branch on the CDN layout's fabricated
    positive indices (:385-430).

The loss functions take leading branch dimensions before (B, nq, ...) and
return one value per branch, so the criterion computes each family of
branches in one call (JAX ``vmap``s them), and the matcher matches every
branch in one call too. Targets: labels (B, G) int, keypoints (B, G, 3K)
xyxy..vv normalized, area (B, G), valid (B, G) bool, valid entries first.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.oks import oks as pair_oks
from ..parallel.dist import all_reduce_counts
from .matcher import hungarian_match

DEFAULT_WEIGHTS = {"loss_vfl": 2.0, "loss_keypoints": 10.0, "loss_oks": 4.0}


def _at_queries(x, idx):
    """x (..., B, nq, D) at the queries idx (..., B, G) -> (..., B, G, D)."""
    idx = idx.expand(x.shape[:-2] + idx.shape[-1:])
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _at_gts(t, idx):
    """A per-GT target t (B, G, ...) at the GTs idx (B, N) -> (B, N, ...)."""
    b = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[b, idx]


def _scatter_to_queries(assign_q, valid, values, nq, fill):
    """Per-GT values (..., B, G) to a (..., B, nq) per-query array, ``fill``
    elsewhere. assign_q (..., B, G) query per GT; valid (B, G)."""
    safe_q = torch.where(valid, assign_q, nq)
    shape = torch.broadcast_shapes(safe_q.shape, values.shape)
    safe_q, values = safe_q.expand(shape), values.expand(shape)
    out = torch.full(safe_q.shape[:-1] + (nq + 1,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter(-1, safe_q, values)[..., :nq]


def _matched_oks(outputs, targets, assign_q, K):
    """Detached OKS of each GT's matched prediction, at least 1e-6 (..., B, G)."""
    valid = targets["valid"]
    zp = _at_queries(outputs["pred_keypoints"][..., :2 * K],
                     torch.where(valid, assign_q, 0))
    oks = pair_oks(zp, targets["keypoints"][..., :2 * K],
                    targets["keypoints"][..., 2 * K:].float(), targets["area"].float(), K)
    return oks.clamp(min=1e-6).detach()


def _class_target(outputs, targets, assign_q, num_classes):
    """One-hot class target per query (..., B, nq, C), 0 on unmatched queries."""
    nq = outputs["pred_logits"].shape[-2]
    tcls = _scatter_to_queries(assign_q, targets["valid"], targets["labels"].long(), nq,
                               num_classes)
    return F.one_hot(tcls, num_classes + 1)[..., :-1].float()


def sigmoid_bce(logits, labels):
    """binary_cross_entropy_with_logits, element-wise (the stable form)."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _masked_sum(l, query_mask):
    if query_mask is not None:
        l = l * query_mask.to(l.dtype)[:, None]
    return l.sum(dim=(-3, -2, -1))


def loss_vfl(outputs, targets, assign_q, num_boxes, K, num_classes=2,
             focal_alpha=0.25, gamma=2.0, query_mask=None):
    """Varifocal loss (criterion.py:58-93). ``query_mask`` (nq,) drops the
    inert static-capacity DN slots, which the reference does not have."""
    logits = outputs["pred_logits"].float()
    nq = logits.shape[-2]
    target = _class_target(outputs, targets, assign_q, num_classes)
    oks = _matched_oks(outputs, targets, assign_q, K)
    tscore = _scatter_to_queries(assign_q, targets["valid"], oks, nq, 0.0)
    target_score = tscore[..., None] * target
    pred_score = torch.sigmoid(logits).detach()
    weight = focal_alpha * pred_score ** gamma * (1 - target) + target_score
    # reference: loss.mean(1).sum() * nq / num_boxes == loss.sum() / num_boxes
    l = sigmoid_bce(logits, target_score) * weight
    return {"loss_vfl": _masked_sum(l, query_mask) / num_boxes}


def loss_labels(outputs, targets, assign_q, num_boxes, K, num_classes=2,
                focal_alpha=0.25, gamma=2.0, query_mask=None):
    """Sigmoid focal loss (criterion.py:38-56, utils.py:47-73)."""
    logits = outputs["pred_logits"].float()
    target = _class_target(outputs, targets, assign_q, num_classes)
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, target)
    p_t = p * target + (1 - p) * (1 - target)
    loss = ce * (1 - p_t) ** gamma
    loss = (focal_alpha * target + (1 - focal_alpha) * (1 - target)) * loss
    return {"loss_ce": _masked_sum(loss, query_mask) / num_boxes}


def loss_mal(outputs, targets, assign_q, num_boxes, K, num_classes=2,
             mal_alpha=None, gamma=2.0, query_mask=None):
    """Matching-aware loss (criterion.py:95-135)."""
    logits = outputs["pred_logits"].float()
    nq = logits.shape[-2]
    target = _class_target(outputs, targets, assign_q, num_classes)
    oks = _matched_oks(outputs, targets, assign_q, K)
    tscore = _scatter_to_queries(assign_q, targets["valid"], oks, nq, 0.0)
    target_score = (tscore[..., None] * target) ** gamma
    pred_score = torch.sigmoid(logits).detach()
    alpha = 1.0 if mal_alpha is None else mal_alpha
    weight = alpha * pred_score ** gamma * (1 - target) + target
    l = sigmoid_bce(logits, target_score) * weight
    return {"loss_mal": _masked_sum(l, query_mask) / num_boxes}


def loss_local(outputs, targets, go_g, go_valid, K, T=5.0, num_pos_neg=None,
               query_mask=None, counts=None):
    """FGL/DDF distillation of the FDR corner distributions against the final
    layer's (teacher) distributions (criterion.py:137-198).

    ``num_pos_neg``: the reference caches num_pos / num_neg from the last
    real branch and reuses them for the DN branches (criterion.py:185-192).
    ``query_mask`` (nq,) drops the inert DN slots from the means and counts.
    ``counts``: the positive and negative elements the means divide by
    (this batch's by default; the global batch's across ranks)."""
    if "pred_corners" not in outputs or "teacher_corners" not in outputs:
        return {}
    pred = outputs["pred_corners"].float()                    # (B, nq, K, 2*(R+1))
    B, nq = pred.shape[:2]
    nbins = pred.shape[-1] // 2
    pc = pred.reshape(B, nq, 2 * K, nbins)
    tc = outputs["teacher_corners"].float().reshape(B, nq, 2 * K, nbins).detach()

    # per-query weights: the teacher's top class probability; matched
    # queries take their OKS
    w = torch.sigmoid(outputs["teacher_logits"].float()).amax(-1)
    g_safe = torch.where(go_valid, go_g, 0)
    kg = _at_gts(targets["keypoints"], g_safe)
    oks = pair_oks(outputs["pred_keypoints"][..., :2 * K], kg[..., :2 * K],
                    kg[..., 2 * K:].float(), _at_gts(targets["area"], g_safe).float(), K)
    w = torch.where(go_valid, oks, w).detach()[..., None]     # (B, nq, 1)

    logp = F.log_softmax(pc / T, dim=-1)
    q = F.softmax(tc / T, dim=-1)
    kl = (q * (torch.log(q + 1e-12) - logp)).sum(-1) * (T ** 2) * w   # (B, nq, 2K)

    pos = go_valid[..., None].expand(kl.shape)
    neg = ~pos
    if query_mask is not None:
        act = query_mask[None, :, None].expand(kl.shape)
        pos, neg = pos & act, neg & act
    if num_pos_neg is None:
        batch_scale = 8.0 / B
        num_pos = torch.sqrt(pos.sum() * batch_scale)
        num_neg = torch.sqrt(neg.sum() * batch_scale)
    else:
        num_pos, num_neg = num_pos_neg
    n_pos, n_neg = (pos.sum(), neg.sum()) if counts is None else counts
    l_pos = torch.where(pos, kl, 0.0).sum() / n_pos.clamp(min=1)
    l_neg = torch.where(neg, kl, 0.0).sum() / n_neg.clamp(min=1)
    return {"loss_dfl": (l_pos * num_pos + l_neg * num_neg) / (num_pos + num_neg + 1e-12)}


def loss_keypoints(outputs, targets, go_g, go_valid, num_boxes_go, K):
    """L1 + OKS losses at the union matching (criterion.py:200-229).
    go_g / go_valid (B, nq) -> per-branch {loss_keypoints, loss_oks}."""
    zp = outputs["pred_keypoints"][..., :2 * K].float()        # (..., B, nq, 2K)
    g_safe = torch.where(go_valid, go_g, 0)
    kg = _at_gts(targets["keypoints"], g_safe).float()         # (B, nq, 3K)
    zg, vg = kg[..., :2 * K], kg[..., 2 * K:]
    area = _at_gts(targets["area"], g_safe).float()
    gv = go_valid.float()
    l1 = (zp - zg).abs() * vg.repeat_interleave(2, dim=-1) * gv[..., None]
    oks_l = (1.0 - pair_oks(zp, zg, vg, area, K).clamp(min=1e-6)) * gv
    return {"loss_keypoints": l1.sum(dim=(-3, -2, -1)) / num_boxes_go,
            "loss_oks": oks_l.sum(dim=(-2, -1)) / num_boxes_go}


def union_indices(assignments: torch.Tensor, valid: torch.Tensor, nq: int):
    """Union ("global optimal") matching across decoder layers
    (criterion.py:247-268): pool every branch's (query, GT) pairs; each query
    keeps the GT it was matched to most often (the first on a tie).

    assignments (M, B, G); valid (B, G) -> go_g (B, nq) int64, go_valid
    (B, nq) bool."""
    safe_q = torch.where(valid, assignments, nq)                      # (M, B, G)
    counts = F.one_hot(safe_q, nq + 1).sum(0).transpose(1, 2)[:, :nq]  # (B, nq, G)
    return counts.argmax(dim=2), counts.amax(dim=2) > 0


def _branch_losses(losses, lg, kp, targets, assign, go_g, go_valid, nb, nb_go, K,
                   num_classes, query_mask=None):
    """The class and keypoint losses of stacked branches (M, B, nq, ...) ->
    {name: (M,)}."""
    o = {"pred_logits": lg, "pred_keypoints": kp}
    out = {}
    if "vfl" in losses:
        out.update(loss_vfl(o, targets, assign, nb, K, num_classes, query_mask=query_mask))
    if "labels" in losses:
        out.update(loss_labels(o, targets, assign, nb, K, num_classes,
                               query_mask=query_mask))
    if "mal" in losses:
        out.update(loss_mal(o, targets, assign, nb, K, num_classes, query_mask=query_mask))
    if "keypoints" in losses:
        out.update(loss_keypoints(o, targets, go_g, go_valid, nb_go, K))
    return out


def criterion(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
              num_body_points: int, num_classes: int = 2,
              weight_dict: Optional[Dict[str, float]] = None,
              matcher_backend: str = "auction", matcher_weights=(2.0, 10.0, 4.0),
              losses: Sequence[str] = ("vfl", "keypoints")) -> Dict[str, torch.Tensor]:
    """The training loss over the final, aux, pre, interm and DN outputs of
    ``DETRPose`` in training -> {term: weighted loss}; the total is the sum.
    ``targets`` may carry ``dn_match`` from the CDN batch.

    Across data-parallel ranks every normaliser is the global batch's, as
    under JAX's pjit, where a sum over the sharded batch is the all-reduce
    (the reference all-reduces num_boxes, criterion.py:317-323): the GT
    counts, the DN counts, and DFL's batch size and element counts, summed
    over the ranks in one all-reduce; and the matcher's auction scale, the
    largest over the ranks. Each rank's terms are then its share
    of the global loss, and their sum over the ranks is the global loss."""
    K = num_body_points
    wd = dict(DEFAULT_WEIGHTS if weight_dict is None else weight_dict)
    cc, ck, co = matcher_weights
    valid = targets["valid"].bool()
    targets = dict(targets, valid=valid)
    nq = outputs["pred_logits"].shape[1]

    # every supervision branch matched in one call: final, aux_0..n-1, pre,
    # enc_0..m-1 share the targets and the query count
    aux_list = outputs.get("aux_outputs", [])
    interm_list = outputs.get("aux_interm_outputs", [])
    branches = [outputs] + list(aux_list) + [outputs["aux_pre_outputs"]] + list(interm_list)
    st_logits = torch.stack([b["pred_logits"] for b in branches])
    st_kpts = torch.stack([b["pred_keypoints"][..., :2 * K] for b in branches])
    # the auction's eps follows the largest cost of the global batch
    assign_all = hungarian_match(st_logits, st_kpts, targets, K, cost_class=cc,
                                 cost_keypoints=ck, cost_oks=co, backend=matcher_backend,
                                 reduce_scale=lambda s: all_reduce_counts(s, "max"))
    go_g, go_valid = union_indices(assign_all, valid, nq)
    B, n_el = valid.shape[0], 2 * K      # DFL counts 2K elements a query
    dn = None
    if "dn_aux_outputs" in outputs and "dn_match" in targets:
        match = targets["dn_match"]
        dn_q, dn_valid, dn_g = match["query_idx"], match["valid"].bool(), match["gt_idx"]
        nq_dn = outputs["dn_aux_outputs"][0]["pred_logits"].shape[1]
        dn_active = match.get("active_mask")
        dn_go_g, dn_go_valid = union_indices(dn_q[None], dn_valid, nq_dn)
        act = torch.ones_like(dn_go_valid) if dn_active is None else dn_active[None]
        dn = [dn_valid.sum(), (dn_go_valid & act).sum(), (~dn_go_valid & act).sum()]

    # every count a normaliser divides by, over the global batch
    counts = all_reduce_counts(torch.stack([
        torch.as_tensor(c, device=valid.device).float()
        for c in [valid.sum(), go_valid.sum(), B] + (dn or [])]))
    num_boxes = counts[0].clamp(min=1.0)
    num_boxes_go = counts[1].clamp(min=1.0)

    suffixes = ([""] + [f"_{i}" for i in range(len(aux_list))] + ["_pre"]
                + [f"_enc_{i}" for i in range(len(interm_list))])
    out_losses: Dict[str, torch.Tensor] = {}
    stacked = _branch_losses(losses, st_logits, st_kpts, targets, assign_all, go_g,
                             go_valid, num_boxes, num_boxes_go, K, num_classes)
    for k, v in stacked.items():
        if k in wd:
            for m, sfx in enumerate(suffixes):
                out_losses[k + sfx] = v[m] * wd[k]

    # FGL/DDF distillation: final + aux branches (the final output has no
    # teacher_corners, so loss_local gives nothing there, as the reference)
    real_num_pos_neg = None
    if "local" in losses:
        n_pos_el = counts[1] * n_el
        n_neg_el = counts[2] * (nq * n_el) - n_pos_el
        batch_scale = 8.0 / counts[2]
        real_num_pos_neg = (torch.sqrt(n_pos_el * batch_scale),
                            torch.sqrt(n_neg_el * batch_scale))
        for sfx, o in [("", outputs)] + [(f"_{i}", a) for i, a in enumerate(aux_list)]:
            for k, v in loss_local(o, targets, go_g, go_valid, K,
                                   num_pos_neg=real_num_pos_neg,
                                   counts=(n_pos_el, n_neg_el)).items():
                if k in wd:
                    out_losses[k + sfx] = v * wd[k]

    # DN branch: fabricated positive indices from the CDN layout
    if dn is not None:
        nb_dn = num_boxes * match["num_group"]
        # targets reordered so column m is GT gt_idx[m]
        dn_targets = {"labels": _at_gts(targets["labels"], dn_g),
                      "keypoints": _at_gts(targets["keypoints"], dn_g),
                      "area": _at_gts(targets["area"], dn_g), "valid": dn_valid}
        nb_dn_go = counts[3].clamp(min=1.0)

        dn_branches = list(outputs["dn_aux_outputs"])
        dn_suffixes = [f"_dn_{i}" for i in range(len(dn_branches))]
        if "dn_aux_pre_outputs" in outputs:
            dn_branches.append(outputs["dn_aux_pre_outputs"])
            dn_suffixes.append("_dn_pre")
        dn_lg = torch.stack([b["pred_logits"] for b in dn_branches])
        dn_kp = torch.stack([b["pred_keypoints"][..., :2 * K] for b in dn_branches])
        # the reference normalizes DN keypoints by num_boxes * scalar
        # (criterion.py:412-414)
        stacked = _branch_losses(losses, dn_lg, dn_kp, dn_targets, dn_q, dn_go_g,
                                 dn_go_valid, nb_dn, nb_dn_go, K, num_classes,
                                 query_mask=dn_active)
        for k, v in stacked.items():
            if k in wd:
                for m, sfx in enumerate(dn_suffixes):
                    out_losses[k + sfx] = v[m] * wd[k]

        # DN distillation: DN indices for the mask and OKS, the real
        # branches' num_pos / num_neg (the reference's "is_dn" gate)
        if "local" in losses:
            for sfx, o in zip(dn_suffixes, dn_branches):
                for k, v in loss_local(o, dn_targets, dn_go_g, dn_go_valid, K,
                                       num_pos_neg=real_num_pos_neg, query_mask=dn_active,
                                       counts=(counts[4] * n_el, counts[5] * n_el)).items():
                    if k in wd:
                        out_losses[k + sfx] = v * wd[k]
    return out_losses
