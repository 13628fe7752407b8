"""The control of ``correct``: the reference computed one precision below
the one the configuration states. The configurations state bfloat16, so the
control computes in float8 (e4m3): the model is cast to bfloat16 as the
program is, every kernel of two dimensions or more is rounded to float8
once, and on every call the input of each convolution and linear layer and
the tensor outputs of every module without children are rounded to float8,
each with a per-tensor scale that maps its largest magnitude to float8's
largest (448). A gradient taken through the control (energy refinement's,
at eval) passes each rounding and is itself rounded to float8 there. The
comparison that decides ``correct`` must call it wrong.
"""
from __future__ import annotations

import torch
import torch.nn as nn

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def _round(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().float().clamp(min=1e-30) / F8_MAX
    return ((x.float() / scale).to(F8).float() * scale).to(x.dtype)


class _ToF8(torch.autograd.Function):
    """The rounding, whose gradient is the incoming one rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def to_f8(x):
    """A floating tensor ``x`` rounded to float8 e4m3 under a per-tensor
    scale, back in its own type; anything else unchanged."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.numel() == 0:
        return x
    return _ToF8.apply(x)


def _round_outputs(_m, _args, out):
    if isinstance(out, (tuple, list)):
        return type(out)(to_f8(o) for o in out)
    return to_f8(out)


def quantize_(net: nn.Module) -> nn.Module:
    """Cast ``net`` to bfloat16 and round it to float8 as above, in place;
    returns ``net``."""
    net.to(torch.bfloat16)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() >= 2:
                p.copy_(to_f8(p))
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_pre_hook(lambda _m, args: (to_f8(args[0]),) + tuple(args[1:]))
        if not any(True for _ in m.children()):
            m.register_forward_hook(_round_outputs)
    return net
