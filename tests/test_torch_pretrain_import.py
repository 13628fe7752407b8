"""The backbone/encoder import (the reference's ``Trainer.pretrain``) in the
port against the JAX package's.

A state_dict written from seeded weights (N, the JAX template filled by
tests/test_torch_models.py's draw, carried into the reference layout) goes
through JAX's ``load_pretrained_backbone_encoder`` into JAX variables drawn
from another seed, and through the port's into a port model holding those
same other-seed weights. Every backbone and encoder leaf, BatchNorm
statistics included, must come out bit-equal to the state_dict's on both
sides, and every decoder/transformer leaf bit-equal to what it was; a key
missing, left over or of another shape raises in the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.utils.convert import load_pretrained_backbone_encoder as jax_import

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.utils.convert import (from_jax_variables,
                                              load_pretrained_backbone_encoder)

from test_torch_models import random_variables

PARTS = ("backbone.", "encoder.")


@pytest.fixture(scope="module")
def weights():
    jm = jax_build_model(jax_model_config("n"))
    template = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 160, 160, 3)), train=False))
    return random_variables(template, seed=21), random_variables(template, seed=22)


def _fresh(variables):
    port = build_model(model_config("n"), device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


def test_import_matches_jax_bit_for_bit(weights):
    pretrained, fresh = weights
    sd = from_jax_variables(pretrained)
    port = _fresh(fresh)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loaded = load_pretrained_backbone_encoder(sd, port)
    after = port.state_dict()
    assert set(loaded) == {k for k in after if k.startswith(PARTS)}
    assert any("running_var" in k for k in loaded)
    want_jax = from_jax_variables(jax_import({k: v.numpy() for k, v in sd.items()}, fresh))
    assert set(want_jax) == set(after)
    n_moved = 0
    for k, v in after.items():
        if k.startswith(PARTS):
            assert torch.equal(v, sd[k]), k
            n_moved += not torch.equal(v, before[k])
        else:
            assert k.startswith("transformer."), k
            assert torch.equal(v, before[k]), k
        assert torch.equal(v, want_jax[k]), k
    assert n_moved == len(loaded)


def test_import_refuses_a_missing_key_or_a_wrong_shape(weights):
    pretrained, fresh = weights
    sd = dict(from_jax_variables(pretrained))
    port = _fresh(fresh)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    key = next(k for k in sd if k.startswith("encoder.") and k.endswith("running_mean"))
    with pytest.raises(KeyError, match="1 keys missing"):
        load_pretrained_backbone_encoder({k: v for k, v in sd.items() if k != key}, port)
    with pytest.raises(KeyError, match="1 keys not in the model"):
        load_pretrained_backbone_encoder(dict(sd, **{"backbone.extra.weight": sd[key]}), port)
    conv = next(k for k in sd if k.startswith("backbone.") and sd[k].dim() == 4)
    with pytest.raises(ValueError, match="shapes differ"):
        load_pretrained_backbone_encoder(dict(sd, **{conv: sd[conv][:, :1]}), port)
    # nothing was loaded by a refused import
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the decoder's keys may be anything: they are dropped
    load_pretrained_backbone_encoder(
        dict(sd, **{"decoder.anything": torch.zeros(3), "transformer.x": torch.ones(1)}), port)
