"""Shared NN building blocks (NCHW inside; eval and train paths).

Counterpart of ``detrpose_tpu/models/layers.py``; the semantics follow the
reference blocks cited per class. Module and parameter names are those of the
original DETRPose ``state_dict`` so a zoo checkpoint loads as it is.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.dist import gather_across_ranks, world
from ..ops.cuda.kan import kan_basis_plain, kan_fused, kan_path


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (reference: hybrid_encoder.py:19-54); GELU is the
    exact erf form, as ``nn.GELU`` defaults to."""
    if name is None:
        return lambda x: x
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "hardsigmoid":
        return F.hardsigmoid
    raise ValueError(f"unknown activation {name!r}")


class BatchNorm(nn.Module):
    """BatchNorm2d, eps 1e-5, momentum 0.1 (JAX ``models/layers.py:45-61``).

    Holds the four tensors of the reference's BatchNorm2d / FrozenBatchNorm2d
    (``weight``, ``bias``, ``running_mean``, ``running_var``) and no
    ``num_batches_tracked``, which nothing reads.

    In training it normalises with the batch statistics and moves the running
    statistics by 0.1 towards them, as Flax's ``nn.BatchNorm`` does: the
    running variance takes the *biased* batch variance. ``F.batch_norm``
    folds in the unbiased one, so the update is corrected after the call:
    with ``rv`` the variance before and ``rv'`` after it, and ``n`` values a
    channel, the biased update is ``((1 - 0.1) rv + (n-1) rv') / n``.

    Across data-parallel ranks (a process group of more than one rank) the
    statistics are those of the global batch, as under JAX's pjit: each
    rank's per-channel count, mean and sum of squared deviations cross the
    ranks in an all-gather with a gradient, so each rank's input gradient is
    that of the global loss, and the running variance takes the biased
    global variance (``torch.nn.SyncBatchNorm`` would fold in the unbiased
    one).
    """

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        if world() > 1:
            return self._sync_forward(x)
        # the call moves a copy (autograd keeps it); the buffer takes the
        # corrected update
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(moved, alpha=n - 1).div_(n)
        return y

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training on the global batch's statistics (in float32 at least):
        each rank's count, mean and sum of squared deviations, gathered and
        combined as Chan et al.'s parallel variance, which keeps the
        precision that E[x^2] - E[x]^2 loses where it cancels."""
        C = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean_r = xf.mean((0, 2, 3))
        m2_r = (xf - mean_r[:, None, None]).square().sum((0, 2, 3))
        count = xf.new_full((1,), x.numel() // C)
        parts = gather_across_ranks(torch.cat([mean_r, m2_r, count]))
        means, m2s, counts = parts[:, :C], parts[:, C:2 * C], parts[:, 2 * C:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * (means - mean).square()).sum(0)) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = xf * scale[:, None, None] + (self.bias - mean * scale)[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return y.to(x.dtype)


class LearnableAffineBlock(nn.Module):
    """``scale * x + bias`` with scalar parameters (hgnetv2.py:63-79)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.bias


class ConvBNAct(nn.Module):
    """Conv + BN + ReLU (+ LearnableAffineBlock). Reference: hgnetv2.py:82-134."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, use_act: bool = True, use_lab: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride,
                              padding=(kernel_size - 1) // 2, groups=groups,
                              bias=False)
        self.bn = BatchNorm(out_chs)
        self.use_act = use_act
        self.lab = LearnableAffineBlock() if (use_act and use_lab) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        if self.use_act:
            x = F.relu(x)
            if self.lab is not None:
                x = self.lab(x)
        return x


class LightConvBNAct(nn.Module):
    """1x1 conv (no act) + depthwise kxk conv (act). Reference: hgnetv2.py:137-166."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int,
                 use_lab: bool = False):
        super().__init__()
        self.conv1 = ConvBNAct(in_chs, out_chs, 1, use_act=False, use_lab=use_lab)
        self.conv2 = ConvBNAct(out_chs, out_chs, kernel_size, groups=out_chs,
                               use_act=True, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class EseModule(nn.Module):
    """Effective-SE channel attention. Reference: hgnetv2.py:223-240."""

    def __init__(self, chs: int):
        super().__init__()
        self.conv = nn.Conv2d(chs, chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv(s))


class ConvNormLayer(nn.Module):
    """Conv + BN + act of the hybrid encoder. Reference: hybrid_encoder.py:114-128."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: Optional[int] = None,
                 bias: bool = False, act: Optional[str] = None):
        super().__init__()
        p = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride, padding=p,
                              groups=groups, bias=bias)
        self.norm = BatchNorm(out_chs)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class VGGBlock(nn.Module):
    """RepVGG 3x3 + 1x1 dual-branch block. Reference: hybrid_encoder.py:139-189.

    ``deploy=True`` is the re-parameterised form the reference's
    ``convert_to_deploy`` leaves: one biased 3x3 ``conv`` (``utils/deploy.py``
    folds the train form's weights into it).
    """

    def __init__(self, in_chs: int, out_chs: int, act: str = "relu",
                 deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.conv = nn.Conv2d(in_chs, out_chs, 3, 1, padding=1, bias=True)
        else:
            self.conv1 = ConvNormLayer(in_chs, out_chs, 3, 1, padding=1)
            self.conv2 = ConvNormLayer(in_chs, out_chs, 1, 1, padding=0)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return self.act(self.conv(x))
        return self.act(self.conv1(x) + self.conv2(x))


class ConvNormLayerFuse(nn.Module):
    """Conv + BN (+ act). Reference: hybrid_encoder.py:56-111; its padding is
    always (k-1)//2.

    ``deploy=True`` is the form the reference's ``convert_to_deploy`` leaves:
    the BatchNorm folded into one biased conv, ``conv_bn_fused``.
    """

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, act: Optional[str] = None,
                 deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        p = (kernel_size - 1) // 2
        if deploy:
            self.conv_bn_fused = nn.Conv2d(in_chs, out_chs, kernel_size, stride,
                                           padding=p, groups=groups, bias=True)
        else:
            self.conv = nn.Conv2d(in_chs, out_chs, kernel_size, stride, padding=p,
                                  groups=groups, bias=bias)
            self.norm = BatchNorm(out_chs)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return self.act(self.conv_bn_fused(x))
        return self.act(self.norm(self.conv(x)))


class SCDown(nn.Module):
    """1x1 projection + depthwise strided downsample. Reference: hybrid_encoder.py:130-137."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int,
                 deploy: bool = False):
        super().__init__()
        self.cv1 = ConvNormLayerFuse(in_chs, out_chs, 1, 1, deploy=deploy)
        self.cv2 = ConvNormLayerFuse(out_chs, out_chs, kernel_size, stride,
                                     groups=out_chs, deploy=deploy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class CSPLayer(nn.Module):
    """CSP bottleneck stack. Reference: hybrid_encoder.py:215-240."""

    def __init__(self, in_chs: int, out_chs: int, num_blocks: int = 3,
                 expansion: float = 1.0, act: str = "silu", deploy: bool = False):
        super().__init__()
        hidden = int(out_chs * expansion)
        self.conv1 = ConvNormLayer(in_chs, hidden, 1, 1, act=act)
        self.conv2 = ConvNormLayer(in_chs, hidden, 1, 1, act=act)
        self.bottlenecks = nn.Sequential(
            *[VGGBlock(hidden, hidden, act=act, deploy=deploy) for _ in range(num_blocks)])
        self.conv3 = (ConvNormLayer(hidden, out_chs, 1, 1, act=act)
                      if hidden != out_chs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bottlenecks(self.conv1(x)) + self.conv2(x)
        return y if self.conv3 is None else self.conv3(y)


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN fusion block of the FPN/PAN. Reference: hybrid_encoder.py:192-212."""

    def __init__(self, in_chs: int, out_chs: int, c3: int, c4: int,
                 num_blocks: int = 3, act: str = "silu", deploy: bool = False):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = ConvNormLayerFuse(in_chs, c3, 1, 1, act=act, deploy=deploy)
        self.cv2 = nn.Sequential(CSPLayer(c3 // 2, c4, num_blocks, act=act, deploy=deploy),
                                 ConvNormLayerFuse(c4, c4, 3, 1, act=act, deploy=deploy))
        self.cv3 = nn.Sequential(CSPLayer(c4, c4, num_blocks, act=act, deploy=deploy),
                                 ConvNormLayerFuse(c4, c4, 3, 1, act=act, deploy=deploy))
        self.cv4 = ConvNormLayerFuse(c3 + 2 * c4, out_chs, 1, 1, act=act, deploy=deploy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.cv1(x)
        y1, y2 = y0[:, :self.c], y0[:, self.c:]
        y3 = self.cv2(y2)
        y4 = self.cv3(y3)
        return self.cv4(torch.cat([y1, y2, y3, y4], dim=1))


class MLP(nn.Module):
    """ReLU MLP head. Reference: src/models/detrpose/utils.py:75-87."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.MultiheadAttention):
    """``nn.MultiheadAttention`` (batch first, packed in-projection) whose
    forward is written out so the softmax runs in float32 whatever the
    working dtype (the JAX package's f32 island, layers.py:350)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__(embed_dim, num_heads, batch_first=True)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        d, h = self.embed_dim, self.num_heads
        dh = d // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(x):  # (N, L, d) -> (N, h, L, dh)
            return x.unflatten(-1, (h, dh)).transpose(1, 2)

        qh = split(F.linear(q, wq, bq))
        kh = split(F.linear(k, wk, bk))
        vh = split(F.linear(v, wv, bv))
        logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
        if attn_mask is not None:
            # bool: True = blocked, finite fill so a fully blocked row stays finite
            logits = (logits.masked_fill(attn_mask, -1e9) if attn_mask.dtype == torch.bool
                      else logits + attn_mask)
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        out = (w @ vh).transpose(1, 2).flatten(-2)
        return self.out_proj(out)


class Gate(nn.Module):
    """Gated residual fusion. Reference: transformer.py:222-235."""

    def __init__(self, d_model: int):
        super().__init__()
        self.gate = nn.Linear(2 * d_model, 2 * d_model)
        self.norm = nn.LayerNorm(d_model)
        self.init_heads_()

    def init_heads_(self) -> None:
        """Zero gate kernel and bias (JAX layers.py:363-365, flax's zero
        bias): both gates start at exactly 0.5 (transformer.py:226-228)."""
        nn.init.zeros_(self.gate.weight)
        nn.init.zeros_(self.gate.bias)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        g1, g2 = torch.sigmoid(self.gate(torch.cat([x1, x2], dim=-1))).chunk(2, dim=-1)
        return self.norm(g1 * x1 + g2 * x2)


class FastKANLayer(nn.Module):
    """RBF approximation of KAN edge splines, the FastKAN FFN variant
    (reference: transformer.py:32-141; JAX ``models/layers.py:373-403``).

    x -> LayerNorm (eps 1e-6) -> ``u = (tanh(x) + 1) / 2 * (G - 1)`` -> a
    Gaussian basis over the G centres 0..G-1 -> the sum over (input, centre)
    with ``coeffs`` (in//2 + 1, in, G) -> ``out_linear``. The sum is JAX's
    einsum ``bdg,rdg->br``, here one matrix product of (N, in*G) by
    (in*G, in//2 + 1): ``ops/cuda/kan.py::kan_basis_plain`` in float32, or
    on the card, where ``kan_path`` allows, the kernel ``csrc/kan_basis.cu``
    inside the profiler range ``kan.fused``. ``coeffs`` is drawn from
    normal(``init_scale``) by ``models/detrpose.py::init_parameters``.
    """

    def __init__(self, in_features: int, out_features: int, grid_size: int = 21,
                 sigma: float = 1.0, init_scale: float = 1e-2):
        super().__init__()
        self.in_features, self.grid_size = in_features, grid_size
        self.sigma, self.init_scale = sigma, init_scale
        rank = in_features // 2 + 1
        self.ln = nn.LayerNorm(in_features, eps=1e-6)
        self.coeffs = nn.Parameter(torch.empty(rank, in_features, grid_size))
        nn.init.normal_(self.coeffs, 0.0, init_scale)
        self.out_linear = nn.Linear(rank, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, D = x.shape[:-1], self.in_features
        xf = self.ln(x.reshape(-1, D))
        if kan_path(xf.device.type, (xf.dtype, self.coeffs.dtype), torch.is_grad_enabled(),
                    (xf.requires_grad, *(p.requires_grad for p in self.parameters())),
                    self.grid_size) == "kernel":
            return kan_fused(xf, self.coeffs, self.sigma, self.out_linear).reshape(lead + (-1,))
        s = kan_basis_plain(xf, self.coeffs, self.sigma).to(x.dtype)
        return self.out_linear(s).reshape(lead + (-1,))


class RMSNorm(nn.Module):
    """RMS normalisation in float32, cast back, times ``weight`` (reference:
    src/models/detrpose/utils.py:140-183; JAX ``models/layers.py:406-417``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return y.to(x.dtype) * self.weight.to(x.dtype)
