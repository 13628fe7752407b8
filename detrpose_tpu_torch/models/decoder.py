"""Deformable pose decoder: MSDeformAttn, LQE, decoder layer and stack.

Counterpart of ``detrpose_tpu/models/decoder.py``, eval and train paths,
with the reference's experimental variants: the MSDeformAttn branches, the
FastKAN FFN and energy refinement. Reference semantics:
src/models/detrpose/transformer.py:263-925 and ms_deform_attn.py:196-513.

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
Kernel #1's op has a gradient (the plain version's, as JAX's ``_fast_bwd``,
itself differentiable, so the energy step's second derivative flows);
kernel #2's has none, as JAX's ``ms_deform_attn_pallas`` has none, so
"pallas" raises where a gradient is wanted. The energy layer runs on the
model's backend, where JAX's always takes its default "auto".
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.msda import ms_deform_attn_fast_flat
from ..ops.cuda.msda_perquery import ms_deform_attn_pallas_flat
from ..ops.fdr import distance2pose, integral
from ..ops.grid_sample import bilinear_grid_sample_nchw
from ..ops.misc import inverse_sigmoid
from ..ops.ms_deform_attn import ms_deform_attn_core
from ..ops.pos_embed import sine_embedding_2d
from ..utils.graphs import device_constant
from ..utils.measure import span
from .layers import (MLP, FastKANLayer, Gate, MultiheadAttention, RMSNorm,
                     get_activation)

SpatialShapes = Sequence[Tuple[int, int]]

MSDA_BACKENDS = ("auto", "sep", "pallas", "gather")

# The experimental MSDeformAttn branches of the reference (ms_deform_attn.py:
# 197-211; JAX decoder.py:85-95), passed by name from the config to each
# decoder layer's cross-attention; all off in the zoo models.
MSDA_BRANCHES = ("use_modulation", "use_region_sampling", "region_kernel_size",
                 "use_global_context", "use_grouped_offsets", "num_groups",
                 "use_grid_attention", "grid_num_points", "use_grid_offsets",
                 "use_grid_fusion")

# focal-style prior of the classification bias (transformer.py:1074-1076)
CLASS_BIAS_PRIOR = -math.log((1 - 0.01) / 0.01)


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int,
                     num_groups: int = 1) -> torch.Tensor:
    """Circle-pattern init of the sampling-offset bias (ms_deform_attn.py:293-312;
    JAX decoder.py:45-68).

    The reference zeroes it when ``n_points % 4 != 0`` with one group (the N
    model's 6 points); with groups the circle is tiled over (nL, nP, G), in
    the order of the offsets' (nH, nL, nP, G, 2) layout.
    """
    if n_points % 4 != 0 and num_groups == 1:
        return torch.zeros(n_heads * n_levels * n_points * 2)
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)           # (nH, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, None, :], (1, n_levels, n_points, num_groups, 1))
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


@device_constant
def _normalizer(spatial_shapes: Tuple[Tuple[int, int], ...],
                device: torch.device) -> torch.Tensor:
    """(1, 1, 1, nL, 1, 2) float32 (W_l, H_l) of each level; shared by
    every caller: read only."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=device)[None, None, None, :, None, :]


@device_constant
def _grid_centres(gs: int, device: torch.device) -> torch.Tensor:
    """(gs * gs, 2) float32 (x, y) centres (i + 0.5) / gs of a gs x gs grid,
    x from the column and y from the row; shared by every caller: read
    only."""
    centers = (np.arange(gs, dtype=np.float32) + 0.5) / gs
    yy, xx = np.meshgrid(centers, centers, indexing="ij")
    return torch.from_numpy(np.stack([xx.reshape(-1), yy.reshape(-1)], -1)).to(device)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable cross-attention. Reference: ms_deform_attn.py:
    196-513; JAX ``MSDeformAttn`` (decoder.py:71-280), every branch in JAX's
    order.

    The reference module has no value or output projection: the concatenated
    weighted samples are the output. The value is the flattened pyramid
    (B, S, nH*dh), so the branches that JAX writes on per-level maps are
    written on its levels' slices:

    * ``use_global_context``: the mean of each level over (H, W, nH), (B, dh)
      a level, concatenated in level order, through ``global_proj`` and added
      to the query behind the gate ``sigmoid(global_gate(query))`` (zero
      kernel, bias 2.0);
    * ``use_grouped_offsets``: ``num_groups`` G sub-heads of dh/G channels a
      head (a view of the channel axis), each with its own offsets, the
      attention weights softmaxed per original head and repeated G times;
    * ``use_modulation``: the weights times ``sigmoid(LayerNorm(
      sampling_modulation(query)) + mod_bias)``, the LayerNorm over (nL, nP),
      ``mod_bias`` 2.0 (the reduction is linear, so this is the reference's
      modulated sample);
    * ``use_region_sampling``: the value maps averaged over k x k windows
      with zero padding counted (``region_kernel_size`` k > 1) before the
      gather;
    * ``use_grid_attention``: a fixed gs x gs grid of points a level
      (``grid_num_points`` = gs^2), with its own softmaxed weights and,
      ``use_grid_offsets``, predicted offsets; a second MSDA call through the
      same backend, fused with the local branch by ``grid_fuse_proj`` on
      their concatenation (``use_grid_fusion``) or added.
    """

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, msda_backend: str = "auto", *,
                 use_modulation: bool = False, use_region_sampling: bool = False,
                 region_kernel_size: int = 1, use_global_context: bool = False,
                 use_grouped_offsets: bool = False, num_groups: int = 1,
                 use_grid_attention: bool = False, grid_num_points: int = 16,
                 use_grid_offsets: bool = False, use_grid_fusion: bool = True):
        super().__init__()
        if msda_backend not in MSDA_BACKENDS:
            raise ValueError(f"unknown msda_backend {msda_backend!r}; "
                             f"expected one of {MSDA_BACKENDS}")
        nH, nL, nP = n_heads, n_levels, n_points
        G = num_groups if use_grouped_offsets else 1
        self.n_levels, self.n_heads, self.n_points, self.groups = nL, nH, nP, G
        self.msda_backend = msda_backend
        self.region_kernel = region_kernel_size if use_region_sampling else 1
        if use_global_context:
            self.global_proj = nn.Linear(d_model // nH * nL, d_model)
            self.global_gate = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, nH * nL * nP * 2 * G)
        self.attention_weights = nn.Linear(d_model, nH * nL * nP)
        if use_modulation:
            self.sampling_modulation = nn.Linear(d_model, nH * nL * nP * G, bias=False)
            self.mod_layernorm = nn.LayerNorm((nL, nP), eps=1e-5)
            self.mod_bias = nn.Parameter(torch.full((1, 1, nH * G, nL, nP), 2.0))
        self.grid_points = 0
        if use_grid_attention:
            gs = math.isqrt(grid_num_points)
            if gs * gs != grid_num_points:
                raise ValueError(f"grid_num_points must be a perfect square, got "
                                 f"{grid_num_points}")
            self.grid_points = grid_num_points
            self.grid_attention_weights = nn.Linear(d_model, nH * nL * grid_num_points)
            if use_grid_offsets:
                self.grid_offsets = nn.Linear(d_model, nH * nL * grid_num_points * 2 * G)
            if use_grid_fusion:
                self.grid_fuse_proj = nn.Linear(2 * d_model, d_model)
        self.init_heads_()

    def init_heads_(self) -> None:
        """JAX's fixed inits (decoder.py:152-201, 248-263): zero projections,
        the circle-pattern offset bias, the global gate's bias and the
        modulation bias at 2.0; ``global_proj`` and ``grid_fuse_proj`` keep
        the lecun kernels and zero biases of ``init_parameters``."""
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(msda_offset_bias(
                self.n_heads, self.n_levels, self.n_points, self.groups))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        if hasattr(self, "global_gate"):
            nn.init.zeros_(self.global_gate.weight)
            nn.init.constant_(self.global_gate.bias, 2.0)
        if hasattr(self, "sampling_modulation"):
            nn.init.zeros_(self.sampling_modulation.weight)
            nn.init.constant_(self.mod_bias, 2.0)
        for name in ("grid_attention_weights", "grid_offsets"):
            if hasattr(self, name):
                nn.init.zeros_(getattr(self, name).weight)
                nn.init.zeros_(getattr(self, name).bias)

    def _heads(self, t: torch.Tensor, n: int, pairs: bool) -> torch.Tensor:
        """A projection (B, Lq, nH*nL*n*G[*2]) in the layout (nH, nL, n, G[, 2])
        -> (B, Lq, nH*G, nL, n[, 2]): each head's G sub-heads in a row
        (JAX decoder.py:166-170)."""
        B, Lq, _ = t.shape
        nH, nL, G = self.n_heads, self.n_levels, self.groups
        tail = (2,) if pairs else ()
        t = t.reshape((B, Lq, nH, nL, n, G) + tail).movedim(5, 3)
        return t.reshape((B, Lq, nH * G, nL, n) + tail)

    def _weights(self, logits: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
        """Softmax over (nL, n) per head, repeated over the head's G sub-heads
        -> (B, Lq, nH*G, nL, n)."""
        B, Lq, _ = logits.shape
        nH, nL, G = self.n_heads, self.n_levels, self.groups
        w = torch.softmax(logits.reshape(B, Lq, nH, nL * n).float(), dim=-1).to(dtype)
        w = w.reshape(B, Lq, nH, 1, nL, n).expand(B, Lq, nH, G, nL, n)
        return w.reshape(B, Lq, nH * G, nL, n)

    def _msda(self, value, spatial_shapes, loc, aw):
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

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value: torch.Tensor, spatial_shapes: SpatialShapes) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B, Lq, 2) float32 in [0, 1];
        value (B, S, nH*dh), the flattened pyramid -> (B, Lq, nH*dh)."""
        with span("decoder.cross_attn"):
            B, Lq, _ = query.shape
            nH, nL, nP = self.n_heads, self.n_levels, self.n_points
            sizes = [int(h) * int(w) for h, w in spatial_shapes]

            if hasattr(self, "global_proj"):
                # per level the mean over (H, W, nH) of its (B, H*W, nH, dh) slice
                pooled = torch.cat([lvl.unflatten(-1, (nH, -1)).mean(dim=(1, 2))
                                    for lvl in value.split(sizes, dim=1)], dim=-1)
                gate = torch.sigmoid(self.global_gate(query))
                query = query + gate * self.global_proj(pooled)[:, None, :]

            offsets = self._heads(self.sampling_offsets(query), nP, pairs=True)
            aw = self._weights(self.attention_weights(query), nP, query.dtype)
            if hasattr(self, "sampling_modulation"):
                # the LayerNorm over (nL, nP), taken over their flattening: the
                # same function, and the CUDA backward of a 2-d normalized_shape
                # returns its scale's gradient flat (torch 2.11)
                ln = self.mod_layernorm
                mod = self._heads(self.sampling_modulation(query), nP, pairs=False)
                mod = F.layer_norm(mod.flatten(-2), (nL * nP,), ln.weight.flatten(),
                                   ln.bias.flatten(), ln.eps).unflatten(-1, (nL, nP))
                aw = aw * torch.sigmoid(mod + self.mod_bias)

            if self.region_kernel > 1:
                # the k x k mean with zero padding counted; an even k pads k//2 on
                # both sides and keeps the first H x W windows, as JAX's slices
                k = self.region_kernel
                value = torch.cat([
                    F.avg_pool2d(lvl.transpose(1, 2).unflatten(-1, (int(h), int(w))), k, 1,
                                 k // 2, count_include_pad=True)[..., :h, :w]
                    .flatten(2).transpose(1, 2)
                    for lvl, (h, w) in zip(value.split(sizes, dim=1), spatial_shapes)], dim=1)

            # loc = ref + offset / (W_l, H_l)   (ms_deform_attn.py:412-416)
            normalizer = _normalizer(tuple((int(h), int(w)) for h, w in spatial_shapes),
                                     query.device)
            loc = reference_points[:, :, None, None, None, :] + offsets.float() / normalizer
            out = self._msda(value, spatial_shapes, loc, aw.float())
            if not self.grid_points:
                return out

            # the coarse grid branch (ms_deform_attn.py:446-510)
            Pg = self.grid_points
            grid_loc = _grid_centres(math.isqrt(Pg), query.device).expand(
                B, Lq, nH * self.groups, nL, Pg, 2)
            gaw = self._weights(self.grid_attention_weights(query), Pg, query.dtype)
            if hasattr(self, "grid_offsets"):
                goff = self._heads(self.grid_offsets(query), Pg, pairs=True)
                grid_loc = grid_loc + goff.float() / normalizer
            grid_out = self._msda(value, spatial_shapes, grid_loc.contiguous(), gaw.float())
            if hasattr(self, "grid_fuse_proj"):
                return self.grid_fuse_proj(torch.cat([out, grid_out], dim=-1))
            return out + grid_out


class LQE(nn.Module):
    """Localization-quality-estimation head. Reference: transformer.py:263-288."""

    def __init__(self, topk: int = 4, hidden_dim: int = 256, num_layers: int = 2,
                 num_body_points: int = 17):
        super().__init__()
        self.topk = topk
        self.reg_conf = MLP(num_body_points * (topk + 1), hidden_dim, 1, num_layers)
        self.init_heads_()

    def init_heads_(self) -> None:
        """Zero last kernel and bias (JAX decoder.py:300, ``zero_init_last``
        with flax's zero bias), so the head starts as the identity on the
        scores."""
        nn.init.zeros_(self.reg_conf.layers[-1].weight)
        nn.init.zeros_(self.reg_conf.layers[-1].bias)

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

    Reference: transformer.py:291-442. ``msda_branches`` (names in
    ``MSDA_BRANCHES``) go to the cross-attention. ``use_kan`` takes the
    FastKAN FFN (``kan1`` -> ReLU -> ``kan2`` -> ``out_linear``) in place of
    ``linear1``/``linear2`` (transformer.py:371-385). ``is_energy`` makes the
    layer an energy head (transformer.py:297-298, 327-329, 397-440):
    ``energy_expand`` lifts an (..., ``energy_in_dim``) state to d_model
    first, and ``energy_reduce`` (no bias), after an optional RMSNorm
    ``input_n_energy``, maps the output to ``energy_out_dim`` energies a token.
    """

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, activation: str = "relu",
                 n_levels: int = 3, n_heads: int = 8, n_points: int = 4,
                 msda_backend: str = "auto", *, use_kan: bool = False, kan_grid: int = 3,
                 is_energy: bool = False, energy_in_dim: int = 68, energy_out_dim: int = 1,
                 normalize_energy: bool = False, **msda_branches):
        super().__init__()
        if is_energy:
            self.energy_expand = nn.Linear(energy_in_dim, d_model)
        self.within_attn = MultiheadAttention(d_model, n_heads)
        self.within_norm = nn.LayerNorm(d_model)
        self.across_attn = MultiheadAttention(d_model, n_heads)
        self.across_norm = nn.LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       msda_backend, **msda_branches)
        self.gateway = Gate(d_model)
        if use_kan:
            self.kan1 = FastKANLayer(d_model, d_ffn, grid_size=kan_grid)
            self.kan2 = FastKANLayer(d_ffn, d_ffn, grid_size=kan_grid)
            self.out_linear = nn.Linear(d_ffn, d_model)
        else:
            self.linear1 = nn.Linear(d_model, d_ffn)
            self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.activation = get_activation(activation)
        if is_energy:
            if normalize_energy:
                self.input_n_energy = RMSNorm(d_model)
            self.energy_reduce = nn.Linear(d_model, energy_out_dim, bias=False)

    def forward(self, tgt: torch.Tensor, query_pos: torch.Tensor,
                reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: SpatialShapes,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B, nq, 1+K, d), or (B, nq, 1+K, energy_in_dim) for an energy
        layer; query_pos (B, nq, K, d); reference_points (B, nq, 1+K, 2)
        float32; value (B, S, d) -> (B, nq, 1+K, d), or the energies
        (B, nq, 1+K, energy_out_dim)."""
        if hasattr(self, "energy_expand"):
            tgt = self.energy_expand(tgt)
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

        if hasattr(self, "kan1"):
            with span("decoder.kan"):
                ff = self.out_linear(self.kan2(F.relu(self.kan1(x))))
        else:
            ff = self.linear2(self.activation(self.linear1(x)))
        x = self.norm2(x + ff)
        if hasattr(self, "energy_reduce"):
            if hasattr(self, "input_n_energy"):
                x = self.input_n_energy(x)
            x = self.energy_reduce(x)
        return x


class TransformerDecoder(nn.Module):
    """Decoder stack with FDR iterative keypoint refinement.

    Reference: transformer.py:446-925; JAX ``_DecoderStep`` and
    ``TransformerDecoder`` (decoder.py:434-823). One module per layer. The
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
    (``torch.utils.checkpoint``). ``layer_kwargs`` (``use_kan``,
    ``kan_grid`` and ``MSDA_BRANCHES``) go to every layer.

    ``use_energy_refinement`` refines the last layer's corners, keypoints
    and logits by ``energy_steps`` steps of descent on the energy of one
    shared ``energy_layer`` (``_energy_refine``).
    """

    def __init__(self, num_layers: int = 6, hidden_dim: int = 256,
                 num_body_points: int = 17, d_ffn: int = 1024,
                 activation: str = "relu", n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, reg_scale: float = 4.0,
                 msda_backend: str = "auto", remat: bool = False, *,
                 reg_max: int = 32, use_energy_refinement: bool = False, energy_steps: int = 3,
                 energy_step_size: float = 0.1, grad_energy: bool = False,
                 energy_decrease_weight: float = 0.0, normalize_energy: bool = False,
                 **layer_kwargs):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.reg_scale = reg_scale
        self.remat = remat
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(hidden_dim, d_ffn, activation, n_levels,
                                   n_heads, n_points, msda_backend, **layer_kwargs)
            for _ in range(num_layers))
        self.half_pose_ref_point_head = MLP(hidden_dim, hidden_dim, hidden_dim, 2)
        if use_energy_refinement:
            # the state a keypoint token: 2*(reg_max+1) corner logits and (x, y);
            # the layer runs on "auto" whatever the model's backend, as JAX
            # builds it without one (detrpose_tpu/models/decoder.py:788-791)
            self.energy_layer = DeformableDecoderLayer(
                hidden_dim, d_ffn, activation, n_levels, n_heads, n_points, "auto",
                is_energy=True, energy_in_dim=2 * (reg_max + 1) + 2, energy_out_dim=1,
                normalize_energy=normalize_energy)
            self.energy_step_size = nn.Parameter(torch.full((1,), float(energy_step_size)))
            self.energy_steps, self.grad_energy = energy_steps, grad_energy
            self.energy_decrease_weight = energy_decrease_weight

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
        pre_poses (B, nq, K, 2), pre_scores (B, nq, C), the energy
        regulariser, a 0-d tensor, or None without energy refinement).
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
            with span("decoder.layer"):
                layer_ref = refpoint_pose
                ref_only_pose = refpoint_pose[:, :, 1:]                    # (B, nq, K, 2)
                with span("decoder.query_pos"):
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
        energy_reg = None
        if hasattr(self, "energy_layer"):
            with span("decoder.energy"):
                corners, kpts, logits, energy_reg = self._energy_refine(
                    corners, kpts, logits, query_pos, layer_ref, value, spatial_shapes,
                    attn_mask)
            if train:
                poses[-1], logits_all[-1], corners_all[-1] = kpts, logits, corners
        if not train:
            return kpts, logits
        return (torch.stack(poses), torch.stack(logits_all), torch.stack(corners_all),
                ref_pose_initial, pre_poses, pre_scores, energy_reg)

    def _energy_refine(self, corners, kpts, logits, query_pos, layer_ref, value,
                       spatial_shapes, attn_mask):
        """Descent on an energy landscape (reference transformer.py:731-901;
        JAX decoder.py:770-823) -> (corners, keypoints, logits, regulariser).

        The state ``z`` (B, nq, K+1, 2*(reg_max+1)+2) packs each keypoint
        token's corner logits and keypoint, then a row of the logits tiled;
        ``energy_layer`` maps it to an energy a token, and ``z`` descends by
        ``energy_step_size`` times the gradient of the mean energy
        (``grad_energy``) or times the raw energy. The regulariser is
        ``energy_decrease_weight * relu(e - e_prev.detach()).mean()`` summed
        over the steps after the first.

        The gradient is taken under ``torch.enable_grad()``: every eval
        entry point calls the model under ``torch.no_grad()``, and JAX takes
        ``jax.grad`` inside its eval program too. It is itself differentiated
        (``create_graph``) when the caller records a graph, as in training.
        Autograd cannot run under ``torch.inference_mode()``, so there
        ``grad_energy`` raises rather than return unrefined outputs. The energy
        layer runs on "auto" (kernel #1 on the card), one call a step and a
        second for the gradient, whatever the model's backend: under
        ``"pallas"`` the main layers launch kernel #2 and the energy layer
        kernel #1, whose op has a gradient.

        Profiler spans: ``decoder.energy`` around the call (in ``forward``),
        ``energy.step`` around each step and ``energy.grad`` around each
        ``torch.autograd.grad``.
        """
        if self.grad_energy and torch.is_inference_mode_enabled():
            raise RuntimeError("energy refinement with grad_energy=True takes a gradient "
                               "at eval, which torch.inference_mode() forbids; call the "
                               "model under torch.no_grad() instead")
        record = torch.is_grad_enabled()
        nc, C = corners.shape[-1], logits.shape[-1]
        zdim = nc + 2
        # float32 at least, as JAX promotes with the keypoints; the layer takes
        # the working dtype
        zt = torch.promote_types(corners.dtype, torch.float32)
        z_pose = torch.cat([corners.to(zt), kpts.to(zt)], dim=-1)    # (B, nq, K, zdim)
        z_logit = logits.to(zt)[:, :, None, :].repeat(1, 1, 1, zdim // C)
        z = torch.cat([z_pose, z_logit], dim=-2)                     # (B, nq, K+1, zdim)

        def energy(zz):
            return self.energy_layer(zz.to(value.dtype), query_pos, layer_ref, value,
                                     spatial_shapes, attn_mask)

        step = self.energy_step_size
        lam = self.energy_decrease_weight
        reg = torch.zeros((), dtype=torch.float32, device=z.device)
        e_prev = None
        for _ in range(self.energy_steps):
            with span("energy.step"):
                e_raw = energy(z)
                e = e_raw.reshape(e_raw.shape[0], -1).mean(1)
                if e_prev is not None and lam > 0:
                    reg = reg + lam * F.relu(e - e_prev.detach()).mean()
                e_prev = e
                if self.grad_energy:
                    with torch.enable_grad():
                        zz = z if z.requires_grad else z.detach().requires_grad_()
                        e_g = energy(zz)
                        # on the card autograd runs the backward on its own
                        # thread while this one waits inside the span
                        with span("energy.grad"):
                            g, = torch.autograd.grad(
                                e_g.reshape(e_g.shape[0], -1).mean(1).sum(), zz,
                                create_graph=record)
                    z = z - step * g
                else:
                    z = z - step * e_raw
        return (z[:, :, :-1, :nc].to(corners.dtype), z[:, :, :-1, nc:].to(kpts.dtype),
                z[:, :, -1, :C].to(logits.dtype), reg)
