"""The serving path's profiler spans (``utils/measure.py::span``) on the CPU:
one ``Pipeline`` call under ``torch.profiler`` records each span as often as
the preset's layers make it, each inside its parent, and with no profiler
running ``span`` is a shared null context and the outputs are bit for bit
those of the profiled call. N with gradient energy refinement adds
``decoder.energy`` once and ``energy.step`` and ``energy.grad`` once a
step, with kernel #1's backward range inside each gradient (the CPU runs
the backward on the calling thread); without refinement none of them
opens."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from detrpose_tpu_torch.configs import model_config
from detrpose_tpu_torch.tools.infer import build_pipeline
from detrpose_tpu_torch.utils.measure import span

RES = 160

# each span and the spans it may lie in (exactly one of them holds it)
PARENT = {
    "detrpose.backbone": ("pipeline.forward",),
    "detrpose.encoder": ("pipeline.forward",),
    "detrpose.transformer": ("pipeline.forward",),
    "encoder.aifi": ("detrpose.encoder",),
    "encoder.fusion": ("detrpose.encoder",),
    "transformer.select": ("detrpose.transformer",),
    "decoder.layer": ("detrpose.transformer",),
    "decoder.query_pos": ("decoder.layer",),
    # the energy layer's cross-attention lies in a refinement step
    "decoder.cross_attn": ("decoder.layer", "energy.step"),
    "decoder.energy": ("detrpose.transformer",),
    "energy.step": ("decoder.energy",),
    "energy.grad": ("energy.step",),
    "msda_fwd_backward": ("energy.grad",),
}
# N with the gradient energy refinement's defaults, 3 steps of 0.1
ENERGY = dict(use_energy_refinement=True, grad_energy=True)


def expected_counts(size: str) -> dict:
    """The spans one ``Pipeline`` call of preset ``size`` records
    ("n-energy": N with ``ENERGY``)."""
    preset, _, variant = size.partition("-")
    cfg = model_config(preset, **(ENERGY if variant == "energy" else {}))
    layers = cfg.num_decoder_layers
    steps = cfg.energy_steps if cfg.use_energy_refinement else 0
    return {"pipeline.upload": 1, "pipeline.preprocess": 1, "pipeline.forward": 1,
            "pipeline.decode": 1, "detrpose.backbone": 1, "detrpose.encoder": 1,
            "detrpose.transformer": 1, "encoder.aifi": len(cfg.use_encoder_idx),
            "encoder.fusion": 1, "transformer.select": 1, "decoder.layer": layers,
            "decoder.query_pos": layers,
            # the energy layer attends twice a step: its energy, its gradient's forward
            "decoder.cross_attn": layers + 2 * steps,
            "decoder.energy": int(steps > 0), "energy.step": steps, "energy.grad": steps,
            "msda_fwd_backward": steps}


@pytest.fixture(scope="module", params=["n", "l", "n-energy"])
def served(request):
    """(size, the spans of one profiled call, its outputs, the same call's
    outputs with no profiler running)."""
    preset, _, variant = request.param.partition("-")
    pipe = build_pipeline(preset, res=RES, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          **(ENERGY if variant == "energy" else {}))
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 120, 200, 3), dtype=np.uint8)
    wh = np.tile(np.float32([200, 120]), (2, 1))
    plain = pipe(frames, wh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipe(frames, wh)
    names = set(expected_counts(request.param))
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events() if e.name in names]
    return request.param, spans, traced, plain


def test_each_span_recorded_as_often_as_the_layers_make_it(served):
    size, spans, _, _ = served
    want = expected_counts(size)
    got = {name: sum(1 for n, *_ in spans if n == name) for name in want}
    assert got == want
    if size == "l":
        assert sum(want.values()) == 28
    if size == "n-energy":
        assert (got["decoder.energy"], got["energy.step"], got["energy.grad"]) == (1, 3, 3)
    else:
        assert got["decoder.energy"] == got["energy.step"] == got["energy.grad"] == 0


def test_each_span_lies_in_its_parent(served):
    _, spans, _, _ = served

    def holder(s, name):
        return [p for p in spans if p[0] == name and p[3] == s[3]
                and p[1] <= s[1] and s[2] <= p[2]]

    for child, parents in PARENT.items():
        for s in (s for s in spans if s[0] == child):
            assert sum(len(holder(s, p)) for p in parents) == 1, (child, parents)
    # the chain from kernel #1's span up to the serving call
    for s in (s for s in spans if s[0] == "decoder.cross_attn"):
        assert holder(s, "decoder.layer") or holder(s, "decoder.energy")
        for name in ("detrpose.transformer", "pipeline.forward"):
            assert holder(s, name), name
    # the four stages of the serving call one after another, none inside another
    stages = sorted((s for s in spans if s[0].startswith("pipeline.")), key=lambda s: s[1])
    assert [s[0] for s in stages] == ["pipeline.upload", "pipeline.preprocess",
                                      "pipeline.forward", "pipeline.decode"]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


def test_no_profiler_means_no_range_and_the_same_outputs(served):
    _, _, traced, plain = served
    assert not torch._C._autograd._profiler_enabled()
    assert isinstance(span("pipeline.forward"), contextlib.nullcontext)
    assert span("pipeline.forward") is span("decoder.layer")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("pipeline.forward"), torch.profiler.record_function)
    assert len(traced) == len(plain) == 3
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)
