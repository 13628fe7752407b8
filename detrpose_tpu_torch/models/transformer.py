"""Transformer top module: memory prep, two-stage query selection, query
tokens, the CDN concat, decoder invocation and output packing.

Counterpart of ``detrpose_tpu/models/transformer.py``. Reference semantics:
src/models/detrpose/transformer.py:929-1420 (``two_stage_type='standard'``).
The per-layer heads live here under the reference's state_dict names
(``pose_embed.{i}``, ``class_embed.{i}``, ``lqe_embed.{i}``, ``pre_pose_embed``).
The CDN embeddings ``label_enc`` and ``pose_enc`` are looked up in training
from the denoising batch of ``train/cdn.py`` (moved to the device by
``cdn_to_device``), so they get gradients.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.fdr import weighting_function
from ..utils.graphs import device_constant
from ..utils.measure import span
from .decoder import CLASS_BIAS_PRIOR, LQE, TransformerDecoder
from .layers import MLP


@device_constant
def _anchors(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device | str):
    all_anchors = []
    for H, W in spatial_shapes:
        gy, gx = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        grid = np.stack([gx, gy], -1)
        grid = (grid + 0.5) / np.array([W, H], dtype=np.float32)
        all_anchors.append(grid.reshape(-1, 2))
    anchors = np.concatenate(all_anchors, 0)[None]                     # (1, S, 2)
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdims=True)
    return (torch.tensor(np.log(anchors / (1 - anchors)), device=device),
            torch.tensor(~valid, device=device))


def make_anchors(spatial_shapes: Sequence[Tuple[int, int]],
                 device: torch.device | str = "cpu"):
    """Per-pixel anchor logits and the invalid mask (transformer.py:1179-1200).

    Returns anchors (1, S, 2) float32 in logit space and invalid (1, S, 1)
    bool, True where an anchor lies outside (0.01, 0.99); built once per
    shapes and device and shared by every caller: read only.
    """
    return _anchors(tuple((int(h), int(w)) for h, w in spatial_shapes), device)


class Transformer(nn.Module):
    """Reference: transformer.py:929-1420; eval and train paths.

    ``decoder_kwargs`` go to ``TransformerDecoder``: the experimental
    branches (``MSDA_BRANCHES``, ``use_kan``, ``kan_grid``) and the energy
    refinement (``use_energy_refinement``, ``energy_steps``,
    ``energy_step_size``, ``grad_energy``, ``energy_decrease_weight``), whose
    regulariser the train dict carries as ``energy_reg_loss``."""

    def __init__(self, hidden_dim: int = 256, nhead: int = 8, num_queries: int = 60,
                 num_decoder_layers: int = 6, dim_feedforward: int = 1024,
                 activation: str = "relu", num_feature_levels: int = 3,
                 dec_n_points: int = 4, num_classes: int = 2,
                 num_body_points: int = 17, reg_max: int = 32,
                 reg_scale: float = 4.0, up: float = 0.5,
                 msda_backend: str = "auto", remat: bool = False, **decoder_kwargs):
        super().__init__()
        hd, K = hidden_dim, num_body_points
        self.hidden_dim, self.num_queries, self.num_body_points = hd, num_queries, K
        self.reg_max, self.reg_scale, self.up = reg_max, reg_scale, up

        self.enc_output = nn.Linear(hd, hd)
        self.enc_output_norm = nn.LayerNorm(hd)
        self.enc_out_class_embed = nn.Linear(hd, num_classes)
        self.enc_pose_embed = MLP(hd, 2 * hd, 2 * K, 4)
        self.tgt_embed = nn.Embedding(num_queries, hd)
        self.keypoint_embedding = nn.Embedding(K, hd)
        self.instance_embedding = nn.Embedding(1, hd)
        self.label_enc = nn.Embedding(80 + 1, hd)
        self.pose_enc = nn.Embedding(K, hd)

        self.decoder = TransformerDecoder(
            num_decoder_layers, hd, K, dim_feedforward, activation,
            num_feature_levels, nhead, dec_n_points, reg_scale, msda_backend, remat,
            reg_max=reg_max, **decoder_kwargs)
        self.pre_pose_embed = MLP(hd, hd, 2, 3)
        self.pose_embed = nn.ModuleList(
            MLP(hd, hd, 2 * (reg_max + 1), 3) for _ in range(num_decoder_layers))
        self.class_embed = nn.ModuleList(
            nn.Linear(hd, num_classes) for _ in range(num_decoder_layers))
        # the LQE head is 256 wide at every model size
        self.lqe_embed = nn.ModuleList(
            LQE(4, 256, 2, K) for _ in range(num_decoder_layers))
        self.init_heads_()

    def init_heads_(self) -> None:
        """JAX's head inits (transformer.py:106-108, 121; decoder.py:524,
        532, 639): the focal prior on the class biases, beside lecun
        kernels, and zero last kernels and biases on the pose regressors."""
        nn.init.constant_(self.enc_out_class_embed.bias, CLASS_BIAS_PRIOR)
        for head in self.class_embed:
            nn.init.constant_(head.bias, CLASS_BIAS_PRIOR)
        for mlp in (self.enc_pose_embed, self.pre_pose_embed, *self.pose_embed):
            nn.init.zeros_(mlp.layers[-1].weight)
            nn.init.zeros_(mlp.layers[-1].bias)

    def forward(self, feats: List[torch.Tensor],
                dn: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """feats: per level (B, hidden, H, W). ``dn``: the denoising batch of
        ``train/cdn.py::cdn_to_device`` (training only).

        Eval -> {pred_logits (B, nq, C), pred_keypoints (B, nq, 2K) float32,
        normalized}. Training -> the JAX train dict (transformer.py:214-288):
        the final layer's logits, keypoints and corners, ``ref_points``, the
        FDR constants, ``aux_outputs`` per earlier layer, ``aux_interm_outputs``
        (the query selection), ``aux_pre_outputs`` (layer 0's pose head) and,
        with ``dn``, the same for the denoising block split off the front
        (``dn_aux_outputs`` per layer, ``dn_aux_pre_outputs``, ``dn_meta``).
        """
        with span("transformer.select"):
            K, hd, nq = self.num_body_points, self.hidden_dim, self.num_queries
            train = self.training
            B = feats[0].shape[0]
            device = feats[0].device
            spatial_shapes = [(int(f.shape[2]), int(f.shape[3])) for f in feats]

            # flatten the pyramid: (B, S, hidden), levels in order, channel-minor.
            # Unmasked, it is also the MSDA value map (B, S, nH*dh).
            memory = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], dim=1)
            if memory.shape[1] < nq:
                raise ValueError(f"input too small: {memory.shape[1]} anchors < "
                                 f"num_queries={nq}")
            anchors, invalid = make_anchors(spatial_shapes, device)

            # two-stage query selection
            output_memory = self.enc_output_norm(
                self.enc_output(memory.masked_fill(invalid, 0.0)))
            enc_class = self.enc_out_class_embed(output_memory)        # (B, S, C)
            topk_idx = enc_class.max(dim=-1).values.topk(nq, dim=1).indices
            topk_memory = output_memory.gather(1, topk_idx[..., None].expand(-1, -1, hd))
            topk_anchors = anchors.expand(B, -1, -1).gather(
                1, topk_idx[..., None].expand(-1, -1, 2))              # (B, nq, 2)
            delta = self.enc_pose_embed(topk_memory).reshape(B, nq, K, 2)
            enc_pose_coord = torch.sigmoid(delta + topk_anchors[:, :, None, :])
            # the decoder's initial reference points carry no gradient (JAX :126)
            refpoints = torch.cat(
                [enc_pose_coord.mean(dim=2, keepdim=True), enc_pose_coord], dim=2).detach()

            # query tokens: learnable content + shared keypoint / instance priors
            tgt = self.tgt_embed.weight[None, :, None, :].expand(B, nq, 1, hd)
            tgt_pose = self.keypoint_embedding.weight[None, None] + tgt  # (B, nq, K, hd)
            tgt_global = self.instance_embedding.weight[None, None].expand(B, nq, 1, hd)
            tgt_tokens = torch.cat([tgt_global, tgt_pose], dim=2).to(memory.dtype)

            # denoising queries in front of the real ones (transformer.py:150-164);
            # unused slots carry zero content (the reference's padding_label)
            attn_mask, pad = None, 0
            if train and dn is not None:
                pad = dn["labels"].shape[1]
                lab = self.label_enc.weight[dn["labels"]]                # (B, pad, hd)
                pose_tok = self.pose_enc.weight[None, None].expand(B, pad, K, hd)
                dn_tokens = torch.cat([lab[:, :, None], pose_tok], dim=2)
                dn_tokens = torch.where(dn["slot_used"][:, :, None, None], dn_tokens, 0.0)
                tgt_tokens = torch.cat([dn_tokens.to(tgt_tokens.dtype), tgt_tokens], dim=1)
                refpoints = torch.cat([torch.sigmoid(dn["pose_logits"]), refpoints], dim=1)
                attn_mask = dn["attn_mask"]

            project = weighting_function(self.reg_max, self.up, self.reg_scale, device)
        dec = self.decoder(
            tgt_tokens, refpoints, memory, spatial_shapes, feats[0], project,
            self.pose_embed, self.class_embed, self.lqe_embed, self.pre_pose_embed,
            attn_mask)
        if not train:
            kpts, logits = dec
            return {"pred_logits": logits, "pred_keypoints": kpts.reshape(B, nq, 2 * K)}

        out_poses, out_logits, out_corners, ref_init, pre_poses, pre_scores, energy_reg = dec
        L = out_poses.shape[0]
        flat = out_poses.flatten(-2)                               # (L, B, pad+nq, 2K)
        pre_flat = pre_poses.flatten(-2)
        dn_poses, poses = flat[:, :, :pad], flat[:, :, pad:]
        dn_logits, logits = out_logits[:, :, :pad], out_logits[:, :, pad:]
        dn_corners, corners = out_corners[:, :, :pad], out_corners[:, :, pad:]
        dn_ref, ref = ref_init[:, :pad], ref_init[:, pad:]
        out = {
            "pred_logits": logits[-1],
            "pred_keypoints": poses[-1],
            "pred_corners": corners[-1],
            "ref_points": ref,
            "up": self.up,
            "reg_scale": self.reg_scale,
            "reg_max": self.reg_max,
            "aux_outputs": [
                {"pred_logits": logits[i], "pred_keypoints": poses[i],
                 "pred_corners": corners[i], "ref_points": ref,
                 "teacher_corners": corners[-1], "teacher_logits": logits[-1]}
                for i in range(L - 1)],
            "aux_interm_outputs": [{
                "pred_logits": enc_class.gather(
                    1, topk_idx[..., None].expand(-1, -1, enc_class.shape[-1])),
                "pred_keypoints": enc_pose_coord.reshape(B, nq, 2 * K)}],
            "aux_pre_outputs": {"pred_logits": pre_scores[:, pad:],
                                "pred_keypoints": pre_flat[:, pad:]},
        }
        if energy_reg is not None:
            # JAX returns 0 here without energy refinement; leaving the key out
            # keeps the default model's logged loss terms JAX's
            out["energy_reg_loss"] = energy_reg
        if pad:
            out["dn_aux_outputs"] = [
                {"pred_logits": dn_logits[i], "pred_keypoints": dn_poses[i],
                 "pred_corners": dn_corners[i], "ref_points": dn_ref,
                 "teacher_corners": dn_corners[-1], "teacher_logits": dn_logits[-1],
                 "is_dn": True}
                for i in range(L)]
            out["dn_aux_pre_outputs"] = {"pred_logits": pre_scores[:, :pad],
                                         "pred_keypoints": pre_flat[:, :pad]}
            out["dn_meta"] = {"pad_size": pad,
                              "num_dn_group": dn["dn_match"]["num_group"]}
        return out
