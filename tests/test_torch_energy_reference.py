"""The port's gradient energy refinement against the benchmark's plain
reference (``h100_bench/reference``, plain float32 torch, MSDA by
``F.grid_sample``) on the CPU: N's widths, 160 px, batch 2, float32, the
port built by its serving entry ``build_pipeline`` with the refinement's
keys, both sides on the same ``h100_bench.weights.draw`` weights. Compared:
the logits, the raw keypoints, and the refinement's own step Δ (the
keypoints returned less those entering the refinement, the argument of
``transformer.lqe_embed[-1]``). With the refinement off both Δ are zero and
the rest still agrees. A port that skipped the refinement reads a relative
Δ error of 1; its keypoints stay within the tolerance and its logits miss
it only just (1.4e-4 to 1.5e-4), so the Δ check is the one that shows it."""
import dataclasses

import pytest
import torch

from detrpose_tpu_torch.configs import model_config
from detrpose_tpu_torch.tools.infer import build_pipeline
from h100_bench import weights
from h100_bench.reference import REQUIRED, VARIANTS, build

RES = 160
# 3 steps of 0.1 are the defaults of model_config and of the reference
ENERGY = dict(use_energy_refinement=True, grad_energy=True)


def block(**overrides) -> dict:
    """N's ``model`` block as a benchmark configuration states it: every key
    the reference reads, from the port's own ``ModelConfig``."""
    cfg = dataclasses.asdict(model_config("n", **overrides))
    return {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()
            if k in REQUIRED + VARIANTS}


def step_taken(net, x):
    """(outputs, Δ (B, nq, K, 2)) of ``net`` on ``x``: Δ is the keypoints
    returned less those that entered ``lqe_embed[-1]``, the last layer's."""
    entered = {}
    hook = net.transformer.lqe_embed[-1].register_forward_hook(
        lambda m, a, out: entered.__setitem__("kpts", a[1]))
    try:
        with torch.no_grad():
            out = net(x)
    finally:
        hook.remove()
    pre = entered["kpts"].float()
    return out, out["pred_keypoints"].float().reshape(pre.shape) - pre


@pytest.mark.parametrize("refine", [True, False], ids=["energy", "plain"])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_plain_reference(seed, refine):
    kw = ENERGY if refine else {}
    port = build_pipeline("n", res=RES, dtype=torch.float32, device="cpu", **kw).model
    model = block(**kw)
    ref = build(model, "cpu")
    shapes = weights.leaf_shapes(port)
    assert shapes == weights.leaf_shapes(ref)
    drawn = weights.draw(shapes, seed, "cpu", model)
    port.load_state_dict(drawn, strict=True)
    ref.load_state_dict(drawn, strict=True)
    x = torch.rand(2, 3, RES, RES, generator=torch.Generator().manual_seed(seed))
    p, dp = step_taken(port, x)
    r, dr = step_taken(ref, x)
    # float32 on both sides, sums in another order (the port's corner
    # gather against grid_sample, its own layer code against the frozen
    # copy): the logits and keypoints, of order 1, agree within 1e-4 (they
    # read 3e-6 at most), as do the Δ
    for k in ("pred_logits", "pred_keypoints"):
        assert (p[k] - r[k]).abs().max() < 1e-4, k
    assert (dp - dr).abs().max() < 1e-4
    if not refine:
        assert not dr.any() and not dp.any()
        return
    # the step moves a keypoint by 5e-5 to 8e-5 here, under the absolute
    # tolerance, so Δ is also held to the reference's relative to its size
    # (read 9e-4 at most): a port that skipped the step would read 1
    assert dr.abs().max() > 0
    assert ((dp - dr).norm() / dr.norm()) < 1e-2
