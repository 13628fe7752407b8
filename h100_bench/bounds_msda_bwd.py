"""What the backward of kernel #1's op (the MSDA forward's gradient, run in
the profiler range ``msda_fwd_backward``) costs at least, from its shapes
alone: the bytes it must move, the operations it must do, and the least
time of one launch at the card's peaks, in the form of
``bounds.py::msda_fwd_bound_s``.

It is the backward that gradient energy refinement takes in serving: the
gradient of the energy layer's MSDA with respect to its sampling locations
and attention weights. The value map needs none there (it comes from the
encoder under ``torch.no_grad()``, and the op's backward computes only the
gradients the running backward uses), so none is written. Whatever
implements the backward, plain PyTorch or a kernel, does at least this.
"""
from __future__ import annotations

from typing import Tuple

from h100_bench.bounds import eval_levels

N_HEADS = 8

# float32 operations per (query, head, level, point, channel):
#   7  the bilinear sample recomputed from its four corners (4 mul, 3 add);
#   2  the attention weight's gradient, grad_out x sample, accumulated;
#   1  the sample's gradient, grad_out x attention weight;
#   14 the location's gradient in x and in y, each the corners' differences
#      along it weighted by the other axis's fractions (2 sub, 2 mul, 1 add),
#      times the sample's gradient, accumulated (1 mul, 1 add): 2 x 7
# What is computed once a tap (the corners' fractions, the scale of a
# normalised location) is left out.
OPS_PER_TAP_CHANNEL = 7 + 2 + 1 + 14


def taps(model: dict, batch: int, queries: int) -> int:
    """(query, head, level, point) tuples of one launch; ``queries`` counts
    the decoder's tokens: queries x (1 + keypoints)."""
    return batch * queries * N_HEADS * model["n_levels"] * model["dec_n_points"]


def msda_bwd_bytes(model: dict, res: int, batch: int, queries: int, value_bytes: int) -> int:
    """Bytes read and written once: the value map and the output's gradient
    in the served type (``value_bytes``; the op's output takes the value
    map's type), the float32 locations (x, y) and weights read, and their
    float32 gradients written."""
    C = model["hidden_dim"]
    S = sum(h * w for h, w in eval_levels(model, res))
    n = taps(model, batch, queries)
    return (batch * S * C * value_bytes               # value
            + batch * queries * C * value_bytes       # output gradient
            + n * (2 * 4 + 4)                         # locations, weights
            + n * (2 * 4 + 4))                        # their gradients


def msda_bwd_operations(model: dict, batch: int, queries: int) -> int:
    """``OPS_PER_TAP_CHANNEL`` for each channel of each tap."""
    return OPS_PER_TAP_CHANNEL * taps(model, batch, queries) * (model["hidden_dim"] // N_HEADS)


def msda_bwd_bound_s(model: dict, res: int, batch: int, queries: int,
                     value_bytes: int, peaks: dict) -> Tuple[float, str]:
    """Least seconds of one backward and what bounds it ("bytes" or
    "operations"): the bytes at the memory rate, or the operations at the
    float32 peak, whichever is longer."""
    t_bytes = msda_bwd_bytes(model, res, batch, queries, value_bytes) / peaks["hbm_bytes_per_s"]
    t_ops = msda_bwd_operations(model, batch, queries) / peaks["f32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
