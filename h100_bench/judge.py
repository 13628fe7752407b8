"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``h100_bench/reference``) run after the
window on the same inputs and the same weights.

Serving (``kinds/serve_closed.py``). The program picks its 60 queries by a
top-k over the encoder's scores and its 60 answers by a top-k over the
decoder's scores. Its encoder scores are bfloat16, so near-ties at the
60th place swap, and under seeded weights the 316 anchors outside the
image's border share one score exactly, a tie each side breaks its own way:
the reference's own top-60 differs from the program's in most runs. So, as
a served language model's tokens are judged by the reference run over
them, the reference is run with the query selection the program made, and
judged:

- ``enc_score_err``: the largest difference of sigmoid(score) between the
  program's encoder scores, which its query selection ranks, and the
  reference's, over every anchor and class: the selection is as good as
  scores this close allow;
- ``score_img_rms``: the root mean square difference of sigmoid(logit),
  the decoder's class scores, over every query and class of one image; the
  worst image. The largest single difference swings from seed to seed
  through the decoder's rounding, the mean square does not;
- ``kpt_rms``: the root mean square difference of a raw keypoint
  coordinate (normalised to [0, 1]) over every query and keypoint of a
  request;
- ``decode_mismatch``: the program's decoded answers (scores, labels,
  keypoints in pixels) against the reference's decode of the program's own
  raw outputs, on the same device in the same types: an exact comparison,
  limit 0. A decode is a top-k, so it is judged on the raw outputs it was
  given, and those are judged above;
- ``energy_kpt_rel``, only where the configuration turns energy refinement
  on: the refinement's own step on the keypoints, Delta = the keypoints the
  model returns less those that entered the refinement (the last layer's
  float32 keypoints, the argument of its ``lqe_embed`` head), on each side;
  ||Delta_prog - Delta_ref|| / ||Delta_ref|| over a request, infinite where
  ||Delta_ref|| is 0 or not finite. The step moves a keypoint by some 1e-5,
  a thousandth of ``kpt_rms``'s limit, so only a number relative to the
  step's own size sees a program that skips or botches it; both sides'
  keypoints are float32, so it reads the gradient's arithmetic, not the
  rounding of the state.

Each number is the worst over the checked requests.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def enc_score_err(scores: torch.Tensor, ref_scores: torch.Tensor) -> float:
    """The program's encoder scores (B, S, C) against the reference's."""
    return float((torch.sigmoid(scores.float()) - torch.sigmoid(ref_scores.float())).abs().max())


def kpt_rms(kpts: torch.Tensor, ref_kpts: torch.Tensor) -> float:
    """The root mean square difference of the program's raw keypoints
    (B, nq, 2K) from the reference's, over the whole request."""
    return float((kpts.float() - ref_kpts.float()).square().mean().sqrt())


def energy_kpt_rel(step: torch.Tensor, ref_step: torch.Tensor) -> float:
    """The program's refinement step on the keypoints (B, nq, K, 2) against
    the reference's: the norm of their difference over the norm of the
    reference's, over the whole request."""
    ref = float(ref_step.double().norm())
    if not math.isfinite(ref) or ref == 0.0:
        return math.inf
    return float((step.double() - ref_step.double()).norm()) / ref


def score_img_rms(logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The root mean square difference of sigmoid(logit), the decoder's
    class scores (B, nq, C), from the reference's over one image's queries
    and classes; the worst image of the request."""
    d = torch.sigmoid(logits.float()) - torch.sigmoid(ref_logits.float())
    return float(d.flatten(1).square().mean(1).sqrt().max())


def selection_differ(chosen: torch.Tensor, ref_scores: torch.Tensor, nq: int) -> torch.Tensor:
    """(B,) how many of the program's ``nq`` chosen anchors lie outside the
    reference's own top ``nq`` by its encoder scores (B, S, C)."""
    own = ref_scores.max(dim=-1).values.topk(nq, dim=1).indices
    hit = (chosen[:, :, None] == own[:, None, :]).any(-1)
    return (~hit).sum(1).cpu()


def decode_mismatch(answers, ref_answers) -> float:
    """The largest difference between the program's decoded (scores,
    labels, keypoints) and the reference's decode of its raw outputs."""
    if any(a.shape != r.shape for a, r in zip(answers, ref_answers)):
        return math.inf
    return max(float((a.double() - r.double()).abs().max()) if a.numel() else 0.0
               for a, r in zip(answers, ref_answers))


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the checked requests; a
    value that is not finite reads as infinite."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v) if math.isfinite(v) else math.inf
    return out
