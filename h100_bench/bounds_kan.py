"""What the FastKAN decoder FFN (``use_kan``: ``kan1`` -> ReLU -> ``kan2``
-> ``out_linear`` in each decoder layer, the program's span ``decoder.kan``)
costs at least for one batch, from the configuration's shapes alone: the
operations of its matrix products, the bytes it must move, and the least
time at the card's peaks, in the form of ``bounds.py::msda_fwd_bound_s``.

A KAN layer of ``d`` inputs and G centres maps a token's Gaussian basis,
``d`` x G values, to ``r = d // 2 + 1`` sums, and ``out_linear`` those to its
outputs. Whatever computes it, a float32 basis written out or one made
inside a fused product's prologue, in float32 or in bfloat16, does these
products; the basis itself (a tanh and an exp a value) is not counted.
"""
from __future__ import annotations

from typing import Tuple


def kan_operations_per_token(model: dict) -> int:
    """Operations of one token through one layer's KAN FFN, 2 per
    multiply-add: ``kan1``'s basis product (D G -> r1) and ``out_linear``
    (r1 -> F), ``kan2``'s (F G -> r2) and (r2 -> F), the layer's
    ``out_linear`` (F -> D); D hidden, F ``dec_dim_feedforward``, G
    ``kan_grid``, r = in // 2 + 1."""
    D, F, G = model["hidden_dim"], model["dec_dim_feedforward"], model["kan_grid"]
    r1, r2 = D // 2 + 1, F // 2 + 1
    return 2 * (D * G * r1 + r1 * F + F * G * r2 + r2 * F + F * D)


def kan_weights(model: dict) -> int:
    """Parameters of one layer's KAN FFN: each KAN layer's LayerNorm,
    ``coeffs`` and ``out_linear``, and the layer's ``out_linear``."""
    D, F, G = model["hidden_dim"], model["dec_dim_feedforward"], model["kan_grid"]

    def kan(d_in, d_out):
        r = d_in // 2 + 1
        return 2 * d_in + r * d_in * G + r * d_out + d_out
    return kan(D, F) + kan(F, F) + F * D + D


def kan_bound_s(model: dict, res: int, batch: int, queries: int, itemsize: int,
                peaks: dict) -> Tuple[float, str]:
    """Least seconds of one batch's KAN FFN over all decoder layers and what
    bounds it ("bytes" or "operations"): the operations at the card's
    highest peak for the served type (``bf16_flop_per_s``), or the FFN's
    input and output in the served type (``itemsize`` bytes) and its weights
    once, at the memory rate, whichever is longer. ``queries`` counts the
    decoder's tokens an image: queries x (1 + keypoints). ``res`` is not
    read: the decoder's tokens do not depend on the image's size."""
    del res
    L, D = model["num_decoder_layers"], model["hidden_dim"]
    tokens = batch * queries
    t_ops = L * tokens * kan_operations_per_token(model) / peaks["bf16_flop_per_s"]
    n_bytes = L * (2 * tokens * D + kan_weights(model)) * itemsize
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
