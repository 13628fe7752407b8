"""What a configuration's work costs, from its shapes alone: kernel #1's
least time (its roofline bound) and the model's operations per image.

Neither reads the program: the bound is arithmetic on the configuration's
sizes, and the operations are counted over the benchmark's own reference
(``h100_bench/reference``) on the meta device, so they stay the same
whatever later implements the work.
"""
from __future__ import annotations

import functools
import json
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the keys of a configuration's ``model`` block that this module reads
READS = ("feat_strides", "n_levels", "hidden_dim", "dec_n_points")


def eval_levels(model: dict, res: int) -> Tuple[Tuple[int, int], ...]:
    """(H, W) of each level the decoder reads at ``res`` px: the encoder's
    outputs at the backbone's strides (8, 16, 32 from the last n_levels)."""
    strides = model["feat_strides"][-model["n_levels"]:]
    return tuple((res // s, res // s) for s in strides)


def msda_fwd_bound_s(model: dict, res: int, batch: int, queries: int,
                     value_bytes: int, peaks: dict) -> Tuple[float, str]:
    """Least seconds of one launch of kernel #1 (the MSDA forward) and what
    bounds it ("bytes" or "operations"): each input read once and the output
    written once at the memory rate (the value map in the served type, the
    float32 locations and weights), or 10 float32 operations per (query,
    head, level, point, channel) at the float32 peak, whichever is longer.
    ``queries`` counts the decoder's tokens: queries x (1 + keypoints)."""
    nH, C = 8, model["hidden_dim"]
    dh, nL, nP = C // nH, model["n_levels"], model["dec_n_points"]
    S = sum(h * w for h, w in eval_levels(model, res))
    taps = batch * queries * nH * nL * nP
    n_bytes = (batch * S * C * value_bytes        # value
               + taps * 2 * 4 + taps * 4         # locations, weights
               + batch * queries * C * value_bytes)   # output
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    t_ops = 10 * taps * dh / peaks["f32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class OpCount(TorchDispatchMode):
    """Sums ``torch.utils.flop_counter.flop_registry``'s operations over
    every call dispatched while it is active, a gradient that the forward
    takes inside (``torch.autograd.grad``) included. An operation the
    registry lacks is decomposed and its parts counted, as
    ``FlopCounterMode`` does; that mode's module tracker cannot follow
    ``autograd.grad`` on a leaf, so it is not used."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


@functools.lru_cache(maxsize=8)
def _serve_flops(model_json: str, res: int, batch: int) -> float:
    from .reference import build
    from .reference.models.postprocess import postprocess

    net = build(json.loads(model_json), "meta")
    x = torch.zeros(batch, 3, res, res, device="meta")
    counter = OpCount()
    with torch.no_grad(), counter:
        out = net(x)
        postprocess(out, torch.ones(batch, 2, device="meta"),
                    num_body_points=json.loads(model_json)["num_body_points"])
    return float(counter.total)


def serve_flops_per_image(model: dict, res: int, batch: int) -> float:
    """Operations of one image's eval forward and decode at ``res`` px, at
    batch ``batch``: convolutions, matrix products and attention, and the
    gradient energy refinement takes, counted by ``OpCount`` over the
    reference on the meta device."""
    return _serve_flops(json.dumps(model, sort_keys=True), res, batch) / batch
