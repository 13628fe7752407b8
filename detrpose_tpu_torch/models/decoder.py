"""Deformable pose decoder: MSDeformAttn, LQE, decoder layer and stack.

Counterpart of ``detrpose_tpu/models/decoder.py`` (default branch), eval and
train paths. Reference semantics: src/models/detrpose/transformer.py:263-925
and ms_deform_attn.py:196-513.

JAX runs the training layers under ``nn.scan`` (``dec_scan``, stacked
parameters) and offers ``scan_layers`` / ``scan_unroll`` to trade its compile
time; those are XLA knobs with no counterpart here. The port keeps one module
per layer (``utils/convert.py`` unstacks the scanned leaves) and runs them in
a Python loop.

The reference adds the keypoint query position embedding *in place*
(transformer.py:359-370), so the positional term persists into the attention
value, the residual stream and the gateway input. That is reproduced with an
explicit add on tokens ``1:``, twice per layer.

``MSDeformAttn(msda_backend=...)`` is the counterpart of the JAX
``MSDeformAttn._msda`` (decoder.py:103-135):
  "auto", "sep"  kernel #1, ``ops/cuda/msda.py`` (the JAX separable kernel's
                 port);
  "pallas"       kernel #2, ``ops/cuda/msda_perquery.py`` (the JAX per-query
                 kernel's port);
  "gather"       the plain version ``ops/ms_deform_attn.py`` on any device (the
                 JAX package's XLA path, chosen by name).
Each kernel's wrapper launches it on a CUDA tensor and runs its plain version
on a CPU tensor. Any other name raises, where JAX would take the gather path.
Kernel #1's op has a gradient (the plain version's, as JAX's ``_fast_bwd``);
kernel #2's has none, as JAX's ``ms_deform_attn_pallas`` has none, so
"pallas" raises where a gradient is wanted.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.msda import ms_deform_attn_fast_flat
from ..ops.cuda.msda_perquery import ms_deform_attn_pallas_flat
from ..ops.fdr import distance2pose, integral
from ..ops.grid_sample import bilinear_grid_sample_nchw
from ..ops.misc import inverse_sigmoid
from ..ops.ms_deform_attn import ms_deform_attn_core
from ..ops.pos_embed import sine_embedding_2d
from .layers import MLP, Gate, MultiheadAttention, get_activation

SpatialShapes = Sequence[Tuple[int, int]]

MSDA_BACKENDS = ("auto", "sep", "pallas", "gather")

# focal-style prior of the classification bias (transformer.py:1074-1076)
CLASS_BIAS_PRIOR = -math.log((1 - 0.01) / 0.01)


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Circle-pattern init of the sampling-offset bias (ms_deform_attn.py:293-312).

    The reference zeroes it when ``n_points % 4 != 0`` (the N model's 6 points).
    """
    if n_points % 4 != 0:
        return torch.zeros(n_heads * n_levels * n_points * 2)
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)           # (nH, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable cross-attention, default branch.

    Reference: ms_deform_attn.py:196-444. The reference module has no value or
    output projection: the concatenated weighted samples are the output.
    """

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, msda_backend: str = "auto"):
        super().__init__()
        if msda_backend not in MSDA_BACKENDS:
            raise ValueError(f"unknown msda_backend {msda_backend!r}; "
                             f"expected one of {MSDA_BACKENDS}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.msda_backend = msda_backend
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.init_heads_()

    def init_heads_(self) -> None:
        """Zero projections and the circle-pattern offset bias (the reference's init)."""
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                msda_offset_bias(self.n_heads, self.n_levels, self.n_points))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor, spatial_shapes: SpatialShapes) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B, Lq, 2) float32 in [0, 1];
        value (B, S, nH*dh), the flattened pyramid -> (B, Lq, nH*dh)."""
        B, Lq, _ = query.shape
        nH, nL, nP = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Lq, nH, nL, nP, 2)
        aw = self.attention_weights(query).reshape(B, Lq, nH, nL * nP)
        aw = torch.softmax(aw.float(), dim=-1).to(query.dtype)
        aw = aw.reshape(B, Lq, nH, nL, nP).float()
        # loc = ref + offset / (W_l, H_l)   (ms_deform_attn.py:412-416)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, None, None, :]
               + offsets.float() / normalizer[None, None, None, :, None, :])
        if self.msda_backend == "gather":
            return ms_deform_attn_core(value, spatial_shapes, loc, aw)
        if self.msda_backend == "pallas":
            if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                            or aw.requires_grad):
                raise RuntimeError(
                    "msda_backend='pallas' (kernel #2) has no gradient, as the JAX "
                    "kernel has none; train with msda_backend='auto' or 'gather'")
            return ms_deform_attn_pallas_flat(value, spatial_shapes, loc, aw)
        return ms_deform_attn_fast_flat(value, spatial_shapes, loc, aw)


class LQE(nn.Module):
    """Localization-quality-estimation head. Reference: transformer.py:263-288."""

    def __init__(self, topk: int = 4, hidden_dim: int = 256, num_layers: int = 2,
                 num_body_points: int = 17):
        super().__init__()
        self.topk = topk
        self.reg_conf = MLP(num_body_points * (topk + 1), hidden_dim, 1, num_layers)
        self.init_heads_()

    def init_heads_(self) -> None:
        """Zero last layer, so the head starts as the identity on the scores."""
        nn.init.zeros_(self.reg_conf.layers[-1].weight)

    def forward(self, scores: torch.Tensor, pred_poses: torch.Tensor,
                feat: torch.Tensor) -> torch.Tensor:
        """scores (B, L, C); pred_poses (B, L, K, 2) in [0, 1]; feat (B, D, H, W)."""
        B, L = pred_poses.shape[:2]
        sampled = bilinear_grid_sample_nchw(feat, 2.0 * pred_poses - 1.0)  # (B, L, K, D)
        topv = sampled.topk(self.topk, dim=-1).values
        stat = torch.cat([topv, topv.mean(dim=-1, keepdim=True)], dim=-1)
        return scores + self.reg_conf(stat.reshape(B, L, -1))


class DeformableDecoderLayer(nn.Module):
    """Within-instance self-attention over the 1+K tokens, across-instance
    self-attention over queries, deformable cross-attention, gated fusion, FFN.

    Reference: transformer.py:291-442 (default flags).
    """

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, activation: str = "relu",
                 n_levels: int = 3, n_heads: int = 8, n_points: int = 4,
                 msda_backend: str = "auto"):
        super().__init__()
        self.within_attn = MultiheadAttention(d_model, n_heads)
        self.within_norm = nn.LayerNorm(d_model)
        self.across_attn = MultiheadAttention(d_model, n_heads)
        self.across_norm = nn.LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       msda_backend)
        self.gateway = Gate(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.activation = get_activation(activation)

    def forward(self, tgt: torch.Tensor, query_pos: torch.Tensor,
                reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: SpatialShapes,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B, nq, 1+K, d); query_pos (B, nq, K, d); reference_points
        (B, nq, 1+K, 2) float32; value (B, S, d) -> (B, nq, 1+K, d)."""
        B, nq, T, d = tgt.shape

        # within-instance self-attention (position added in place)
        x = torch.cat([tgt[:, :, :1], tgt[:, :, 1:] + query_pos], dim=2)
        xf = x.reshape(B * nq, T, d)
        x = self.within_norm(x + self.within_attn(xf, xf, xf).reshape(B, nq, T, d))

        # across-instance self-attention per token slot
        xt = x.transpose(1, 2).reshape(B * T, nq, d)
        xt = self.across_norm(xt + self.across_attn(xt, xt, xt, attn_mask))
        x = xt.reshape(B, T, nq, d).transpose(1, 2)

        # deformable cross-attention (position added in place again)
        x = torch.cat([x[:, :, :1], x[:, :, 1:] + query_pos], dim=2)
        ca = self.cross_attn(x.reshape(B, nq * T, d),
                             reference_points.reshape(B, nq * T, 2),
                             value, spatial_shapes)
        x = self.gateway(x, ca.reshape(B, nq, T, d))

        ff = self.linear2(self.activation(self.linear1(x)))
        return self.norm2(x + ff)


class TransformerDecoder(nn.Module):
    """Decoder stack with FDR iterative keypoint refinement.

    Reference: transformer.py:446-925; JAX ``_DecoderStep`` and
    ``TransformerDecoder`` (decoder.py:434-769). One module per layer. The
    per-layer prediction heads (``pose_embed``, ``class_embed``,
    ``lqe_embed``) and the layer-0 ``pre_pose_embed`` belong to the enclosing
    Transformer, as in the reference's state_dict, and are passed in.

    At eval the class and LQE heads run on the last layer only
    (transformer.py:726, 907-908). In training they run on every layer, the
    per-layer outputs are stacked for deep supervision, the layer-0 pose head
    gives ``pre_poses`` and the class head ``pre_scores``, the initial
    reference is detached, and so are the new reference points and
    ``output_pose`` between layers (decoder.py:519-520, 546-548). ``remat``
    recomputes each layer in the backward pass of training
    (``torch.utils.checkpoint``).
    """

    def __init__(self, num_layers: int = 6, hidden_dim: int = 256,
                 num_body_points: int = 17, d_ffn: int = 1024,
                 activation: str = "relu", n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, reg_scale: float = 4.0,
                 msda_backend: str = "auto", remat: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.reg_scale = reg_scale
        self.remat = remat
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(hidden_dim, d_ffn, activation, n_levels,
                                   n_heads, n_points, msda_backend)
            for _ in range(num_layers))
        self.half_pose_ref_point_head = MLP(hidden_dim, hidden_dim, hidden_dim, 2)

    def forward(self, tgt: torch.Tensor, refpoints_sigmoid: torch.Tensor,
                value: torch.Tensor, spatial_shapes: SpatialShapes,
                feat_lqe: torch.Tensor, project: torch.Tensor,
                pose_embed: Sequence[nn.Module], class_embed: Sequence[nn.Module],
                lqe_embed: Sequence[nn.Module], pre_pose_embed: nn.Module,
                attn_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """tgt (B, nq, 1+K, d); refpoints_sigmoid (B, nq, 1+K, 2); value
        (B, S, d); feat_lqe (B, d, H8, W8); attn_mask (nq, nq) bool, True =
        blocked.

        Eval: (keypoints (B, nq, K, 2) float32, logits (B, nq, num_classes)).
        Training: (poses (L, B, nq, K, 2) float32, logits (L, B, nq, C),
        corners (L, B, nq, K, 2*(reg_max+1)), ref_pose_initial (B, nq, K, 2),
        pre_poses (B, nq, K, 2), pre_scores (B, nq, C)).
        """
        train = self.training
        out = tgt
        # keypoint positions are carried in float32 whatever the working dtype
        refpoint_pose = refpoints_sigmoid.float()
        output_pose_detach = torch.zeros_like(tgt[:, :, 1:])
        pred_corners = None
        ref_pose_initial = pre_poses = pre_scores = None
        poses, logits_all, corners_all = [], [], []
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            ref_only_pose = refpoint_pose[:, :, 1:]                    # (B, nq, K, 2)
            sine = sine_embedding_2d(ref_only_pose, self.hidden_dim).to(out.dtype)
            query_pos = self.half_pose_ref_point_head(sine)
            if self.remat and train and torch.is_grad_enabled():
                out = checkpoint(layer, out, query_pos, refpoint_pose, value,
                                 spatial_shapes, attn_mask, use_reentrant=False)
            else:
                out = layer(out, query_pos, refpoint_pose, value, spatial_shapes,
                            attn_mask)
            output_pose = out[:, :, 1:]

            if i == 0:
                pre = pre_pose_embed(output_pose)
                pre_poses = torch.sigmoid(pre + inverse_sigmoid(ref_only_pose)).float()
                ref_pose_initial = pre_poses.detach() if train else pre_poses

            corners = pose_embed[i](output_pose + output_pose_detach)
            if pred_corners is not None:
                corners = corners + pred_corners
            kpts = distance2pose(ref_pose_initial, integral(corners, project),
                                 self.reg_scale)                      # (B, nq, K, 2)
            refpoint_pose = torch.cat([kpts.mean(dim=2, keepdim=True), kpts], dim=2)
            output_pose_detach = output_pose
            if train:
                refpoint_pose = refpoint_pose.detach()
                output_pose_detach = output_pose.detach()
            pred_corners = corners
            if train or i == last:
                score = class_embed[i](out[:, :, 0])
                logits = lqe_embed[i](score, kpts, feat_lqe)
                if i == 0:
                    pre_scores = score
            if train:
                poses.append(kpts)
                logits_all.append(logits)
                corners_all.append(corners)
        if not train:
            return kpts, logits
        return (torch.stack(poses), torch.stack(logits_all), torch.stack(corners_all),
                ref_pose_initial, pre_poses, pre_scores)
