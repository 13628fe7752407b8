"""The stage split (``tools/component_slope.py``, the counterpart of
tools_local_component_slope.py) against the JAX model's stages.

N at 160 px, batch 2, float32, seeded weights carried into the port (the
draw of tests/test_torch_models.py, the selection head scaled by 50): the
backbone's maps, the encoder's maps (``model.backbone.apply`` and
``model.encoder.apply`` as tools_local_component_slope.py:62-73 calls them),
the full forward's logits and keypoints and the postprocessed detections,
each within 1e-4 of JAX's; the tool's deltas are the differences of its
stages, and on the CPU it launches no kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from detrpose_tpu.models.postprocess import postprocess as jax_postprocess

from detrpose_tpu_torch.tools.component_slope import (ALONE, DELTAS, STAGES, component_slope,
                                                      first_leaf, stage_fns)

from test_torch_e2e import _check_decoded
from test_torch_variants_model import HW, _port, _weights

torch.set_num_threads(2)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4, err_msg=what)


def test_stages_match_jax():
    jm, v = _weights("n", {})
    port = _port("n", {}, v).eval()
    x = np.random.default_rng(11).uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    sizes = np.array([[640, 480], [333, 500]], np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    fns = stage_fns(port, torch.from_numpy(sizes), 17)
    assert tuple(fns) == STAGES

    feats = jm.backbone.apply({"params": v["params"]["backbone"],
                               "batch_stats": v["batch_stats"]["backbone"]}, xj, False)
    enc_vars = {"params": v["params"]["encoder"]}
    if "encoder" in v.get("batch_stats", {}):
        enc_vars["batch_stats"] = v["batch_stats"]["encoder"]
    enc = jm.encoder.apply(enc_vars, feats, False)
    full = jm.apply(v, xj, train=False)
    with torch.no_grad():
        got = {name: fn(xt) for name, fn in fns.items()}
    for name, want in (("backbone", feats), ("backbone+encoder", enc)):
        assert len(got[name]) == len(want)
        for i, (g, w) in enumerate(zip(got[name], want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w, f"{name} map {i}")
    for k in ("pred_logits", "pred_keypoints"):
        _close(got["full (no postprocess)"][k].numpy(), full[k], k)
    _check_decoded(got["full + postprocess"], jax_postprocess(full, jnp.asarray(sizes)))
    assert first_leaf(got["full (no postprocess)"]) is got["full (no postprocess)"][
        "pred_keypoints"]


def test_tool_deltas_and_launches():
    r = component_slope("n", batch=1, res=HW, iters=1, dtype=torch.float32, warmup=0,
                        rounds=2, device="cpu")
    assert r[ALONE] > 0
    for name in STAGES:
        assert r[name] > 0, name
        assert not any(r["launches"][name].values()), name
    for name, (a, b) in DELTAS.items():
        assert r[name] == pytest.approx(r[a] - r[b], abs=0)
