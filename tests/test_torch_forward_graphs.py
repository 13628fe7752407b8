"""The forward's dispatch on the card (``utils/graphs.py``): constants kept
on the device, and the backbone and encoder replayed as CUDA graphs.

On the CPU: each kept constant equals the numpy construction the forward
made on every call before, bit for bit, at DETRPose-L's shapes; forwards
leave every kept constant as it was; and ``eager_reason`` keeps the eager
forward wherever a graph cannot engage. The tests marked ``gpu`` hold the
graphed forward to the eager one on the card and skip without a CUDA
device. The file imports no JAX:

  python -m pytest --noconftest -m gpu tests/test_torch_forward_graphs.py
"""
import copy
import math

import numpy as np
import pytest
import torch

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models.decoder import _grid_centres, _normalizer
from detrpose_tpu_torch.ops.cuda.kan import _kan_centres
from detrpose_tpu_torch.models.transformer import make_anchors
from detrpose_tpu_torch.ops.fdr import weighting_function
from detrpose_tpu_torch.ops.pos_embed import (_frequencies, _interleave_sin_cos,
                                              sine_hw_position_embedding)
from detrpose_tpu_torch.utils.graphs import CONSTANTS, eager_reason, tracing

CPU = torch.device("cpu")
# DETRPose-L at 640 px: levels at strides 8, 16, 32, AIFI on the last
L_SHAPES = ((80, 80), (40, 40), (20, 20))


def _numpy_sine_hw(w, h, hidden_dim, temperature_w, temperature_h):
    scale, eps = 2.0 * math.pi, 1e-6
    grid_w = np.arange(1, w + 1, dtype=np.float32)
    grid_h = np.arange(1, h + 1, dtype=np.float32)
    gh, gw = np.meshgrid(grid_h, grid_w, indexing="ij")
    gw = gw / (w + eps) * scale
    gh = gh / (h + eps) * scale
    i = np.arange(hidden_dim, dtype=np.float32)
    dim_tx = temperature_w ** (2.0 * (i // 2) / hidden_dim)
    dim_ty = temperature_h ** (2.0 * (i // 2) / hidden_dim)
    pos_x = _interleave_sin_cos(torch.from_numpy(gw[..., None] / dim_tx))
    pos_y = _interleave_sin_cos(torch.from_numpy(gh[..., None] / dim_ty))
    return torch.cat([pos_y, pos_x], dim=-1).reshape(1, h * w, -1)


def _numpy_anchors(shapes):
    parts = []
    for H, W in shapes:
        gy, gx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                             indexing="ij")
        grid = (np.stack([gx, gy], -1) + 0.5) / np.array([W, H], dtype=np.float32)
        parts.append(grid.reshape(-1, 2))
    anchors = np.concatenate(parts, 0)[None]
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdims=True)
    return torch.tensor(np.log(anchors / (1 - anchors))), torch.tensor(~valid)


def _numpy_weighting(reg_max, up, reg_scale):
    up, reg_scale = abs(up), abs(reg_scale)
    ub1, ub2 = up * reg_scale, up * reg_scale * 2.0
    step = (ub1 + 1.0) ** (2.0 / (reg_max - 2))
    left = [-(step ** i) + 1.0 for i in range(reg_max // 2 - 1, 0, -1)]
    right = [step ** i - 1.0 for i in range(1, reg_max // 2)]
    return torch.tensor(np.array([-ub2] + left + [0.0] + right + [ub2], dtype=np.float32))


def _numpy_grid(gs):
    centers = (np.arange(gs, dtype=np.float32) + 0.5) / gs
    yy, xx = np.meshgrid(centers, centers, indexing="ij")
    return torch.from_numpy(np.stack([xx.reshape(-1), yy.reshape(-1)], -1))


# (kept constant, the numpy construction) at L's shapes
L_CONSTANTS = {
    "frequencies": (lambda: _frequencies(256, CPU), lambda: torch.from_numpy(
        10000.0 ** (2.0 * (np.arange(128, dtype=np.float32) // 2) / 128))),
    "sine_hw": (lambda: sine_hw_position_embedding(20, 20, 128, 20.0, 20.0, device=CPU),
                lambda: _numpy_sine_hw(20, 20, 128, 20.0, 20.0)),
    "anchors": (lambda: make_anchors(list(L_SHAPES), CPU), lambda: _numpy_anchors(L_SHAPES)),
    "weighting": (lambda: weighting_function(32, 0.5, 4.0, CPU),
                  lambda: _numpy_weighting(32, 0.5, 4.0)),
    "normalizer": (lambda: _normalizer(L_SHAPES, CPU), lambda: torch.tensor(
        [[w, h] for h, w in L_SHAPES], dtype=torch.float32)[None, None, None, :, None, :]),
    "grid": (lambda: _grid_centres(4, CPU), lambda: _numpy_grid(4)),
    # FastKAN's basis centres at kan_grid 3
    "kan_centres": (lambda: _kan_centres(3, CPU),
                    lambda: torch.from_numpy(np.arange(3, dtype=np.float32))),
}


def _tensors(value):
    return value if isinstance(value, tuple) else (value,)


@pytest.mark.parametrize("name", sorted(L_CONSTANTS))
def test_kept_constant_is_the_numpy_construction(name):
    kept, numpy_built = L_CONSTANTS[name]
    got, want = _tensors(kept()), _tensors(numpy_built())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    # kept: the second call hands out the same tensors
    assert all(a is b for a, b in zip(_tensors(kept()), got))


def _snapshot():
    return {(get.__qualname__, key): [t.clone() for t in _tensors(value)]
            for get in CONSTANTS for key, value in get.cache.items()}


@pytest.mark.parametrize("variant", [
    {},
    {"use_energy_refinement": True, "grad_energy": True},
    {"use_grid_attention": True, "use_grid_offsets": True},
    {"use_kan": True, "kan_grid": 3},
])
def test_forwards_leave_the_constants_as_they_were(variant):
    """Two eval forwards in float32 give the same outputs, and neither they
    nor a training forward and backward between them write to a kept
    constant."""
    torch.manual_seed(0)
    model = build_model(model_config("n", **variant), device=CPU,
                        generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, 3, 160, 160)
    with torch.no_grad():
        first = model(x)
    kept = _snapshot()
    assert any(name.endswith("_normalizer") for name, _ in kept)

    trained = copy.deepcopy(model).train()
    out = trained(x)
    (out["pred_logits"].sum() + out["pred_keypoints"].sum()).backward()
    with torch.no_grad():
        second = model(x)
    for k in ("pred_logits", "pred_keypoints"):
        assert torch.equal(first[k], second[k])
    after = _snapshot()
    for key, values in kept.items():
        assert all(torch.equal(a, b) for a, b in zip(values, after[key])), key


class _Probe(torch.nn.Module):
    """Records in ``reasons`` the ``eager_reason`` of ``stage`` at each
    call."""

    def __init__(self, stage, reasons):
        super().__init__()
        self.stage, self.record = stage, reasons.append

    def forward(self, x):
        self.record(eager_reason(self.stage, [x]))
        return x + 1


def test_the_graphs_engage_only_where_the_input_allows():
    stage = build_model(model_config("n"), device=CPU).backbone.eval()
    x = torch.zeros(1, 3, 64, 64)
    with torch.no_grad():
        assert eager_reason(stage, [x]) == "device"
        stage.train()
        assert eager_reason(stage, [x]) == "training"
        stage.eval()
    assert eager_reason(stage, [x]) == "grad"
    with torch.no_grad():
        torch.set_autocast_enabled("cuda", True)
        try:
            assert eager_reason(stage, [x]) == "autocast"
        finally:
            torch.set_autocast_enabled("cuda", False)
    reasons = []
    with torch.no_grad():
        torch.export.export(_Probe(stage, reasons), (x,))
    assert reasons and set(reasons) == {"tracing"}
    assert not tracing()
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        assert tracing()


def test_graphs_are_dropped_where_the_weights_move_or_training_starts():
    stage = build_model(model_config("n"), device=CPU).backbone.eval()
    stage._graphs["key"] = object()
    stage.eval()
    assert stage._graphs                 # eval keeps them
    stage.train()
    assert not stage._graphs
    stage.eval()
    stage._graphs["key"] = object()
    stage.to(torch.float64)              # new storage for every weight
    assert not stage._graphs


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    return torch.device("cuda")


def _l_model(cuda, **overrides):
    return build_model(model_config("l", dtype=torch.bfloat16, **overrides), device=cuda,
                       generator=torch.Generator().manual_seed(0))


def _inputs(cuda, n=2, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.rand(2, 3, 320, 320, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(n)]


@torch.no_grad()
def _eager(model, x):
    return model.transformer(model.encoder.run(model.backbone.run(x)))


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("pred_logits", "pred_keypoints"))


@pytest.mark.gpu
def test_graphed_forward_is_the_eager_forward(cuda):
    model = _l_model(cuda)
    x1, x2 = _inputs(cuda)
    with torch.no_grad():
        got = [model(x1), model(x2), model(x1)]
    assert len(model.backbone._graphs) == 1 and len(model.encoder._graphs) == 1
    for out, x in zip(got, (x1, x2, x1)):
        assert _equal(out, _eager(model, x))
    assert not torch.equal(got[0]["pred_logits"], got[1]["pred_logits"])


def _pool_of(ptr):
    for seg in torch.cuda.memory_snapshot():
        if seg["address"] <= ptr < seg["address"] + seg["total_size"]:
            return tuple(seg["segment_pool_id"])
    raise AssertionError(f"no segment holds {ptr:#x}")


@pytest.mark.gpu
def test_outputs_are_fresh_memory(cuda):
    model = _l_model(cuda)
    x1, x2 = _inputs(cuda)
    with torch.no_grad():
        outs = [model(x1), model(x2)]
    ptrs = [out[k].untyped_storage().data_ptr() for out in outs
            for k in ("pred_logits", "pred_keypoints")]
    assert len(set(ptrs)) == len(ptrs)
    static = [t.untyped_storage().data_ptr() for stage in (model.backbone, model.encoder)
              for g in stage._graphs.values() for t in g.outputs + g.inputs]
    assert not set(ptrs) & set(static)
    assert {_pool_of(p) for p in ptrs} == {(0, 0)}     # the allocator's own pool


@pytest.mark.gpu
def test_replay_reads_weights_loaded_later(cuda):
    model = _l_model(cuda)
    x1, _ = _inputs(cuda)
    with torch.no_grad():
        model(x1)
        graphs = [dict(model.backbone._graphs), dict(model.encoder._graphs)]
        g = torch.Generator(device=cuda).manual_seed(1)
        moved = {k: v + 0.01 * torch.randn(v.shape, generator=g, device=cuda, dtype=v.dtype)
                 if v.is_floating_point() else v for k, v in model.state_dict().items()}
        model.load_state_dict(moved)
        out = model(x1)
    # the same graphs, replayed on the new weights
    assert [dict(model.backbone._graphs), dict(model.encoder._graphs)] == graphs
    assert _equal(out, _eager(model, x1))


@pytest.mark.gpu
def test_autocast_forward_stays_eager(cuda):
    """Under autocast (the Trainer's evaluation of float32 weights) the
    stages run eagerly and read weights loaded between calls."""
    model = build_model(model_config("l"), device=cuda, generator=torch.Generator().manual_seed(0))
    x1, _ = _inputs(cuda)
    x1 = x1.float()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model(x1)
        model.load_state_dict({k: v * 1.01 if v.is_floating_point() else v
                               for k, v in model.state_dict().items()})
        out = model(x1)
        want = _eager(model, x1)
    assert not model.backbone._graphs and not model.encoder._graphs
    assert _equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [{}, {"use_energy_refinement": True,
                                            "grad_energy": True}])
def test_serving_forward_never_synchronises(cuda, overrides):
    model = _l_model(cuda, **overrides)
    x1, x2 = _inputs(cuda)
    with torch.no_grad():
        model(x1), model(x2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(x1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert model.backbone._graphs and model.encoder._graphs
