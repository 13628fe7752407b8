"""The port's FastKAN decoder FFN (``use_kan``) against the benchmark's plain
reference (``h100_bench/reference``, plain float32 torch, MSDA by
``F.grid_sample``) on the CPU: N's widths, 160 px, batch 2, float32, the
port built by its serving entry ``build_pipeline`` with ``use_kan=True,
kan_grid=3``, both sides on the same ``h100_bench.weights.draw`` weights.
Compared: the logits and the raw keypoints. A port whose ``kan2`` skipped
its basis misses by orders of magnitude (1.95 and 0.15 on seed 0). Under
the profiler the span ``decoder.kan`` opens once a decoder layer, inside
it, and never with ``use_kan`` off."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detrpose_tpu_torch.configs import model_config
from detrpose_tpu_torch.tools.infer import build_pipeline
from h100_bench import weights
from h100_bench.reference import REQUIRED, VARIANTS, build

RES = 160
KAN = dict(use_kan=True, kan_grid=3)
# float32 on both sides, sums in another order (the port's corner gather
# against grid_sample, its own layer code against the frozen copy): the
# logits and keypoints, of order 1, agree within 1e-4 (they read 1.9e-6 and
# 3.0e-7 at most over seeds 0-2)
TOL = 1e-4


def block(**overrides) -> dict:
    """N's ``model`` block as a benchmark configuration states it: every key
    the reference reads, from the port's own ``ModelConfig``."""
    cfg = dataclasses.asdict(model_config("n", **overrides))
    return {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()
            if k in REQUIRED + VARIANTS}


def pair(seed: int):
    """(port, reference, input) on the seed's weights and a seeded batch."""
    port = build_pipeline("n", res=RES, dtype=torch.float32, device="cpu", **KAN).model
    model = block(**KAN)
    ref = build(model, "cpu")
    shapes = weights.leaf_shapes(port)
    assert shapes == weights.leaf_shapes(ref)
    drawn = weights.draw(shapes, seed, "cpu", model)
    port.load_state_dict(drawn, strict=True)
    ref.load_state_dict(drawn, strict=True)
    x = torch.rand(2, 3, RES, RES, generator=torch.Generator().manual_seed(seed))
    return port, ref, x


def largest_gap(port, ref, x) -> dict:
    with torch.no_grad():
        p, r = port(x), ref(x)
    return {k: float((p[k] - r[k]).abs().max()) for k in ("pred_logits", "pred_keypoints")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_the_plain_reference(seed):
    port, ref, x = pair(seed)
    assert all(hasattr(layer, "kan2") for layer in port.transformer.decoder.layers)
    gaps = largest_gap(port, ref, x)
    assert all(g < TOL for g in gaps.values()), gaps


def test_a_skipped_basis_fails_the_comparison():
    """Each layer's ``kan2`` as its ``out_linear`` alone, on the first
    ``in // 2 + 1`` features of its input: LayerNorm, the Gaussian basis and
    the coefficients' sum skipped."""
    port, ref, x = pair(0)
    for layer in port.transformer.decoder.layers:
        kan2 = layer.kan2
        rank = kan2.out_linear.in_features
        kan2.forward = lambda h, kan2=kan2, rank=rank: kan2.out_linear(h[..., :rank])
    gaps = largest_gap(port, ref, x)
    assert all(g > 100 * TOL for g in gaps.values()), gaps


@pytest.mark.parametrize("use_kan", [True, False], ids=["kan", "mlp"])
def test_the_kan_span_opens_once_a_decoder_layer(use_kan):
    pipe = build_pipeline("n", res=RES, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          **(KAN if use_kan else {}))
    x = torch.rand(1, 3, RES, RES, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.model(x)
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
             if e.name in ("decoder.kan", "decoder.layer")]
    kan = [s for s in spans if s[0] == "decoder.kan"]
    layers = [s for s in spans if s[0] == "decoder.layer"]
    assert len(layers) == model_config("n").num_decoder_layers
    assert len(kan) == (len(layers) if use_kan else 0)
    for s in kan:
        assert sum(1 for p in layers if p[3] == s[3] and p[1] <= s[1] and s[2] <= p[2]) == 1
