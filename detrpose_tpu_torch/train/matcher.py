"""Hungarian matching: the cost and two assignment solvers.

Counterpart of ``detrpose_tpu/train/matcher.py``. The cost follows the
reference HungarianMatcher (src/models/detrpose/matcher.py:46-97): focal class
cost + visibility-weighted L1 keypoint cost + (1 - OKS), weights (2, 10, 4).

``auction_assign`` is JAX's on-device solver: one epsilon phase of a
Bertsekas auction, 128 fixed rounds, ties broken to the first index (as
``jnp.argmax`` and ``torch.argmax`` both do), on whatever device the cost
lies. ``scipy_assign`` is the reference's exact LSAP on the host. Every
function takes leading dimensions before (B, ...): the criterion stacks its
supervision branches in front and matches them in one call, as JAX's
``vmap`` does; each leading index is its own problem (its own auction
scale).

Targets are batched and padded: labels (B, G) int; keypoints (B, G, 3K)
xyxy..vv; area (B, G); valid (B, G) bool, valid entries first. An
assignment is (..., B, G) int64, the query matched to each GT (0 where not
valid).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.oks import oks

BIG = 1e6


def match_cost(pred_logits: torch.Tensor, pred_keypoints: torch.Tensor,
               targets: Dict[str, torch.Tensor], num_body_points: int,
               cost_class: float = 2.0, cost_keypoints: float = 10.0,
               cost_oks: float = 4.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """(..., B, nq, C) logits and (..., B, nq, 2K) keypoints -> the (..., B,
    nq, G) matching cost; invalid GT columns get +BIG."""
    K = num_body_points
    gamma = 2.0
    p = torch.sigmoid(pred_logits.float())
    one_m_p = (1.0 - p).clamp(min=0.0)
    neg = (1 - focal_alpha) * p ** gamma * (-torch.log(one_m_p + 1e-8))
    pos = focal_alpha * one_m_p ** gamma * (-torch.log(p.clamp(min=0.0) + 1e-8))
    labels = targets["labels"].long().clamp(0, p.shape[-1] - 1)      # (B, G)
    nq, G = p.shape[-2], labels.shape[-1]
    idx = labels[:, None, :].expand(p.shape[:-2] + (nq, G))
    c_class = torch.gather(pos - neg, -1, idx)                       # (..., B, nq, G)

    zp = pred_keypoints[..., :2 * K].float()                          # (..., B, nq, 2K)
    zg = targets["keypoints"][..., :2 * K].float()                    # (B, G, 2K)
    vg = targets["keypoints"][..., 2 * K:].float()                    # (B, G, K)
    v2 = vg.repeat_interleave(2, dim=-1)
    c_kpt = ((zp[..., :, None, :] - zg[:, None]).abs() * v2[:, None]).sum(-1)

    sim = oks(zp[..., :, None, :], zg[:, None], vg[:, None],
              targets["area"].float()[:, None], K)                    # (..., B, nq, G)
    c_oks = 1.0 - sim.clamp(min=1e-6)

    c = cost_class * c_class + cost_keypoints * c_kpt + cost_oks * c_oks
    return torch.where(targets["valid"].bool()[:, None, :], c, BIG)


@torch.no_grad()
def auction_assign(cost: torch.Tensor, valid: torch.Tensor, iters: int = 128,
                   reduce_scale: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Min-cost assignment by a Bertsekas auction (JAX matcher.py:83-155).

    Columns (GTs) bid for rows (queries): each unassigned column bids its
    best-minus-second-best net value + eps on its best query; the highest bid
    takes the query and evicts its owner. One phase from zero prices at eps =
    1e-3 * scale, ``scale`` the largest finite |cost| of the problem (at least
    1), for ``iters`` rounds.

    Args:
      cost: (..., B, nq, G); valid: (B, G) or (..., B, G) bool.
      reduce_scale: maps the batch's scales (...,) to those of the problem
        it is part of (the criterion passes the max over data-parallel ranks,
        so eps is the global batch's, as under JAX's pjit); None keeps them.
    Returns:
      (..., B, G) int64, the query per GT (distinct within an image).
    """
    *lead, B, nq, G = cost.shape
    value = -cost.float().transpose(-1, -2)                          # (..., B, G, nq)
    valid = valid.bool().expand(tuple(lead) + (B, G))
    value = torch.where(valid[..., None], value, -BIG)
    finite = torch.where(value.abs() < BIG / 2, value, 0.0).abs()
    scale = finite.flatten(-3).amax(-1)                              # (...,)
    if reduce_scale is not None:
        scale = reduce_scale(scale)
    scale = scale.clamp(min=1.0)
    eps = (1e-3 * scale)[..., None, None].expand(tuple(lead) + (B, 1)).reshape(-1, 1)

    value = value.reshape(-1, G, nq)
    valid = valid.reshape(-1, G)
    N = value.shape[0]
    cols = torch.arange(G, device=cost.device)
    qs = torch.arange(nq, device=cost.device)
    price = torch.zeros((N, nq), device=cost.device)
    owner = torch.full((N, nq), -1, dtype=torch.long, device=cost.device)
    assigned = torch.full((N, G), -1, dtype=torch.long, device=cost.device)
    for _ in range(iters):
        net = value - price[:, None, :]                              # (N, G, nq)
        best_v = net.amax(dim=-1)
        best = net.argmax(dim=-1)
        is_best = best[..., None] == qs                              # (N, G, nq)
        second_v = torch.where(is_best, -torch.inf, net).amax(dim=-1)
        bid = best_v - second_v + eps
        active = valid & (assigned < 0)
        bid_mat = torch.where(active[..., None] & is_best, bid[..., None], -torch.inf)
        win_bid = bid_mat.amax(dim=1)                                # (N, nq)
        win_col = bid_mat.argmax(dim=1)
        got = win_bid > -torch.inf
        new_owner = torch.where(got, win_col, owner)
        price = torch.where(got, price + win_bid, price)
        still = (assigned >= 0) & (new_owner.gather(1, assigned.clamp(min=0)) == cols)
        won = active & (new_owner.gather(1, best) == cols) & got.gather(1, best)
        assigned = torch.where(won, best, torch.where(still, assigned, -1))
        owner = new_owner
    return assigned.clamp(min=0).reshape(tuple(lead) + (B, G))


@torch.no_grad()
def scipy_assign(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The reference's exact assignment (matcher.py:97): scipy's
    ``linear_sum_assignment`` on the host over each problem's valid columns.
    cost (..., B, nq, G), valid (B, G) or (..., B, G) -> (..., B, G) int64 on
    the cost's device."""
    from scipy.optimize import linear_sum_assignment

    *lead, B, nq, G = cost.shape
    c = cost.float().cpu().numpy().reshape(-1, nq, G)
    v = valid.bool().expand(tuple(lead) + (B, G)).cpu().numpy().reshape(-1, G)
    out = np.zeros((c.shape[0], G), np.int64)
    for b in range(c.shape[0]):
        g = int(v[b].sum())
        if g == 0:
            continue
        r, col = linear_sum_assignment(c[b, :, :g])
        out[b, col] = r
    return torch.from_numpy(out.reshape(tuple(lead) + (B, G))).to(cost.device)


def hungarian_match(pred_logits, pred_keypoints, targets, num_body_points,
                    cost_class=2.0, cost_keypoints=10.0, cost_oks=4.0,
                    focal_alpha=0.25, backend="auction", reduce_scale=None) -> torch.Tensor:
    """The full matcher: cost, then assignment ("auction" or "scipy") ->
    (..., B, G) int64. ``reduce_scale`` as ``auction_assign``'s."""
    if backend not in ("auction", "scipy"):
        raise ValueError(f"unknown matcher backend {backend!r}")
    with torch.no_grad():
        c = match_cost(pred_logits, pred_keypoints, targets, num_body_points,
                       cost_class, cost_keypoints, cost_oks, focal_alpha)
    if backend == "scipy":
        return scipy_assign(c, targets["valid"])
    return auction_assign(c, targets["valid"], reduce_scale=reduce_scale)
