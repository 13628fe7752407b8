"""The reference's model variants in the port against the JAX package.

Module level: ``MSDeformAttn`` with each experimental branch of the reference
(modulation, region sampling, global context, grouped offsets, grid
attention with offsets and fusion) at N's width (d 128, 8 heads, 2 levels, 6
points) against JAX ``MSDeformAttn.apply`` (1e-5 of the output's scale);
the FastKAN FFN and the energy head (``DeformableDecoderLayer`` with
``use_kan`` / ``is_energy`` and its RMSNorm) likewise; the energy refinement
alone (two differentiated steps, the regulariser live) and the gradients of
a loss on its outputs against ``jax.grad`` (1e-4); ``FastKANLayer`` and
``RMSNorm`` to 1e-6; ResNet-50 at 64 px to 1e-4 (its conv sums are ordered
differently by XLA and PyTorch). Weights are the seeded numpy draw of
tests/test_torch_models.py, carried by ``from_jax_variables``; every new
leaf goes back through JAX's ``convert_state_dict`` bit for bit.

Kernel #1's op (``ms_deform_attn_fast_flat``) differentiated twice, against
the plain version in float64 (1e-10): its backward is recorded when it runs
under grad mode, so a second derivative reaches its inputs; its first-order
gradient stays the plain version's bit for bit, inside the profiler range
``msda_fwd_backward``.

A variant's deploy form (``fuse_for_deploy``) carries every leaf outside
the encoder and answers as its train form (1e-4). Whole models are in
tests/test_torch_variants_model.py, the energy training step in
tests/test_torch_variants_train.py.
"""
import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detrpose_tpu.configs import build_model as jax_build_model
from detrpose_tpu.configs import model_config as jax_model_config
from detrpose_tpu.models.decoder import DeformableDecoderLayer as JLayer
from detrpose_tpu.models.decoder import MSDeformAttn as JMSDeformAttn
from detrpose_tpu.models.decoder import TransformerDecoder as JDecoder
from detrpose_tpu.models.decoder import _msda_offset_bias_init
from detrpose_tpu.models.layers import FastKANLayer as JFastKAN
from detrpose_tpu.models.layers import RMSNorm as JRMSNorm
from detrpose_tpu.models.resnet import ResNet as JResNet
from detrpose_tpu.train.optim import make_optimizer as jax_make_optimizer
from detrpose_tpu.utils.convert import convert_state_dict

from detrpose_tpu_torch.configs import build_model, model_config
from detrpose_tpu_torch.models import DeformableDecoderLayer, MSDeformAttn, TransformerDecoder
from detrpose_tpu_torch.models.decoder import msda_offset_bias
from detrpose_tpu_torch.models.layers import FastKANLayer, RMSNorm
from detrpose_tpu_torch.models.resnet import ResNet
from detrpose_tpu_torch.ops.cuda.msda import BACKWARD_RANGE, ms_deform_attn_fast_flat
from detrpose_tpu_torch.ops.cuda.msda_perquery import MSDAPerQuery, pack_points, pack_value
from detrpose_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core
from detrpose_tpu_torch.utils.convert import from_jax_variables
from detrpose_tpu_torch.train.optim import label_parameters, resolve_backbone_freeze
from detrpose_tpu_torch.utils.deploy import fuse_for_deploy

from test_torch_models import _close, _nchw, _nhwc, load_port, random_variables

torch.set_num_threads(2)

# N's decoder geometry: d 128 = 8 heads x 16 channels, 2 levels, 6 points
D, NH, NL, NP = 128, 8, 2, 6
SHAPES = [(10, 12), (5, 6)]

# the flag sets of chip_smoke.py phase 11 (a), and an even region kernel
BRANCHES = {
    "modulation": dict(use_modulation=True),
    "region3": dict(use_region_sampling=True, region_kernel_size=3),
    "region2": dict(use_region_sampling=True, region_kernel_size=2),
    "global": dict(use_global_context=True),
    "grouped2_mod": dict(use_grouped_offsets=True, num_groups=2, use_modulation=True),
    "grouped4": dict(use_grouped_offsets=True, num_groups=4),
    "grid16_offsets": dict(use_grid_attention=True, grid_num_points=16, use_grid_offsets=True),
    "grid4_nofusion": dict(use_grid_attention=True, grid_num_points=4, use_grid_fusion=False),
    "everything": dict(use_global_context=True, use_grouped_offsets=True, num_groups=2,
                       use_modulation=True, use_region_sampling=True, region_kernel_size=3,
                       use_grid_attention=True, grid_num_points=9, use_grid_offsets=True),
}


# ---------------------------------------------------------------- kernel #1's op

def _op_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    S = sum(h * w for h, w in SHAPES[:2])
    B, Lq, nH, dh, nL, nP = 2, 5, 2, 4, 2, 3
    f64 = dict(dtype=torch.float64)
    value = torch.randn(B, S, nH * dh, generator=g, **f64).requires_grad_()
    loc0 = torch.rand(B, Lq, nH, nL, nP, 2, generator=g, **f64) * 1.2 - 0.1
    z = torch.rand(B, Lq, nH, nL, nP, 2, generator=g, **f64).requires_grad_()
    aw = torch.rand(B, Lq, nH, nL, nP, generator=g, **f64).requires_grad_()
    w = torch.tensor([1.0, 0.3], **f64).requires_grad_()
    return value, loc0, z, aw, w


def _second_order(op, value, loc0, z, aw, w):
    loc = loc0 * w[0] + z * w[1]
    e = (op(value, SHAPES, loc, aw) ** 2).sum()
    g, = torch.autograd.grad(e, z, create_graph=True)
    return torch.autograd.grad((g ** 2).sum(), [w, value, aw])


def test_op_second_derivative_matches_plain():
    inputs = _op_inputs(0)
    got = _second_order(ms_deform_attn_fast_flat, *inputs)
    want = _second_order(ms_deform_attn_core, *inputs)
    assert want[0].abs().min() > 1.0      # both terms of d/dw are far from 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_op_first_order_gradient_unchanged():
    value, loc0, z, aw, _ = _op_inputs(1)
    loc = (loc0 + z).detach().requires_grad_()
    grads = {}
    for op in (ms_deform_attn_fast_flat, ms_deform_attn_core):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = op(value, SHAPES, loc, aw)
            grads[op] = torch.autograd.grad((out ** 2).sum(), [value, loc, aw])
        ranges = [e.name for e in prof.events() if e.name == BACKWARD_RANGE]
        assert len(ranges) == (1 if op is ms_deform_attn_fast_flat else 0)
    for a, b in zip(grads[ms_deform_attn_fast_flat], grads[ms_deform_attn_core]):
        assert torch.equal(a, b)
        assert a.grad_fn is None            # a first-order gradient records nothing


# ---------------------------------------------------------------- MSDeformAttn

@pytest.mark.parametrize("G,nP", [(1, 4), (1, 6), (2, 6), (4, 4)])
def test_offset_bias_matches_jax(G, nP):
    n = NH * NL * nP * 2 * G
    np.testing.assert_array_equal(msda_offset_bias(NH, NL, nP, G).numpy(),
                                  np.asarray(_msda_offset_bias_init(NH, NL, nP, G)(None, (n,))))


def _msda_inputs(seed, B=2, Lq=7):
    rng = np.random.default_rng(seed)
    query = rng.normal(size=(B, Lq, D)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, Lq, 2)).astype(np.float32)
    levels = [rng.normal(size=(B, h, w, NH, D // NH)).astype(np.float32) for h, w in SHAPES]
    return query, refs, levels


@pytest.mark.parametrize("name", list(BRANCHES))
def test_msdeformattn_branch_matches_jax(name):
    flags = BRANCHES[name]
    query, refs, levels = _msda_inputs(3)
    jm = JMSDeformAttn(D, NL, NH, NP, **flags)
    args = (jnp.asarray(query), jnp.asarray(refs), [jnp.asarray(v) for v in levels], SHAPES)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = random_variables(template, seed=4)
    want = jm.apply(variables, *args)
    port = load_port(MSDeformAttn(D, NL, NH, NP, **flags), variables)
    value = torch.cat([torch.from_numpy(v).reshape(2, -1, D) for v in levels], dim=1)
    with torch.no_grad():
        got = port(torch.from_numpy(query), torch.from_numpy(refs), value, SHAPES)
    _close(got, want, 1e-5)


def test_msdeformattn_init_matches_jax():
    # JAX's own init of every new leaf carries over (zero kernels, 2.0 biases)
    query, refs, levels = _msda_inputs(5)
    flags = BRANCHES["everything"]
    jm = JMSDeformAttn(D, NL, NH, NP, **flags)
    args = (jnp.asarray(query), jnp.asarray(refs), [jnp.asarray(v) for v in levels], SHAPES)
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), *args)))
    port = MSDeformAttn(D, NL, NH, NP, **flags)
    sd, want = port.state_dict(), from_jax_variables(variables)
    for name in ("sampling_offsets.weight", "sampling_offsets.bias", "attention_weights.weight",
                 "attention_weights.bias", "global_gate.weight", "global_gate.bias",
                 "sampling_modulation.weight", "mod_bias", "mod_layernorm.weight",
                 "mod_layernorm.bias", "grid_attention_weights.weight",
                 "grid_attention_weights.bias", "grid_offsets.weight", "grid_offsets.bias"):
        torch.testing.assert_close(sd[name], want[name], rtol=0, atol=0, msg=name)


def test_kernel2_takes_the_grid_branch_points():
    # kernel #2's input checks take the grid branch's 3 levels x 16 points a
    # query (its generic point loop; the checks once stopped at 32)
    levels = ((8, 8), (4, 4), (2, 2))
    value = torch.zeros(1, sum(h * w for h, w in levels), 8 * 32)
    loc, aw = torch.rand(1, 5, 8, 3, 16, 2), torch.rand(1, 5, 8, 3, 16)
    MSDAPerQuery._check(pack_value(value, 8), levels, *pack_points(loc, aw))


def test_grid_points_must_be_a_square():
    with pytest.raises(ValueError, match="perfect square"):
        MSDeformAttn(D, NL, NH, NP, use_grid_attention=True, grid_num_points=8)


# ---------------------------------------------------------------- FFN, energy head

def test_fastkan_matches_jax():
    x = np.random.default_rng(6).normal(size=(3, 5, 32)).astype(np.float32)
    jm = JFastKAN(32, 48, grid_size=3)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_variables(template, seed=7)
    want = jm.apply(variables, jnp.asarray(x))
    port = load_port(FastKANLayer(32, 48, grid_size=3), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, 1e-6)


def test_rmsnorm_matches_jax():
    x = np.random.default_rng(8).normal(size=(4, 6, 32)).astype(np.float32) * 3.0
    jm = JRMSNorm(32)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = random_variables(template, seed=9)
    want = jm.apply(variables, jnp.asarray(x))
    port = load_port(RMSNorm(32), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("kind", ["kan", "energy"])
def test_decoder_layer_variant_matches_jax(kind):
    B, nq, K = 2, 3, 5
    rng = np.random.default_rng(10)
    width = 2 * 9 + 2 if kind == "energy" else D
    tgt = rng.normal(size=(B, nq, K + 1, width)).astype(np.float32)
    qpos = rng.normal(size=(B, nq, K, D)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, nq, K + 1, 2)).astype(np.float32)
    levels = [rng.normal(size=(B, h, w, NH, D // NH)).astype(np.float32) for h, w in SHAPES]
    kw = (dict(use_kan=True, kan_grid=3, use_modulation=True) if kind == "kan" else
          dict(is_energy=True, energy_in_dim=width, normalize_energy=True))
    jm = JLayer(D, 96, n_levels=NL, n_heads=NH, n_points=NP, **kw)
    args = (jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(refs),
            [jnp.asarray(v) for v in levels], SHAPES)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = random_variables(template, seed=11)
    want = jm.apply(variables, *args)
    port = load_port(DeformableDecoderLayer(D, 96, "relu", NL, NH, NP, **kw), variables)
    value = torch.cat([torch.from_numpy(v).reshape(B, -1, D) for v in levels], dim=1)
    with torch.no_grad():
        got = port(torch.from_numpy(tgt), torch.from_numpy(qpos), torch.from_numpy(refs),
                   value, SHAPES)
    _close(got, want, 1e-5)


class _JRefine(JDecoder):
    """JAX's ``_energy_refine`` alone: its energy layer and step size."""

    @fnn.compact
    def __call__(self, *args):
        return self._energy_refine(*args)


def test_energy_refine_matches_jax():
    # two differentiated steps of ascent (a negative step size), so the
    # regulariser relu(e - e_prev) is live: the outputs, the regulariser and
    # the gradients of a loss on them (through the second derivative)
    B, nq, K, reg_max = 2, 3, 4, 8
    kw = dict(hidden_dim=D, num_body_points=K, d_ffn=64, n_levels=NL, n_heads=NH,
              n_points=NP, reg_max=reg_max, use_energy_refinement=True, energy_steps=2,
              grad_energy=True, energy_decrease_weight=0.5)
    rng = np.random.default_rng(16)
    corners = rng.normal(size=(B, nq, K, 2 * (reg_max + 1))).astype(np.float32)
    kpts = rng.uniform(0, 1, (B, nq, K, 2)).astype(np.float32)
    logits = rng.normal(size=(B, nq, 2)).astype(np.float32)
    qpos = rng.normal(size=(B, nq, K, D)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, nq, K + 1, 2)).astype(np.float32)
    levels = [rng.normal(size=(B, h, w, NH, D // NH)).astype(np.float32) for h, w in SHAPES]
    jm = _JRefine(**kw)
    args = [jnp.asarray(a) for a in (corners, kpts, logits, qpos, refs)]
    args += [[jnp.asarray(v) for v in levels], SHAPES, None]
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = random_variables(template, seed=17)
    variables["params"]["energy_step_size"] = np.full((1,), -20.0, np.float32)

    def loss(params):
        c, k, lg, reg = jm.apply({"params": params}, *args)
        return (k ** 2).sum() + (c ** 2).mean() + lg.sum() + reg, reg

    (loss_j, reg_j), grads_j = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    assert float(reg_j) > 0
    port = TransformerDecoder(0, D, K, 64, "relu", NL, NH, NP, reg_max=reg_max,
                              use_energy_refinement=True, energy_steps=2, grad_energy=True,
                              energy_decrease_weight=0.5).train()
    missing, unexpected = port.load_state_dict(from_jax_variables(variables), strict=False)
    assert not unexpected and all(k.startswith("half_pose_ref_point_head.") for k in missing)
    value = torch.cat([torch.from_numpy(v).reshape(B, -1, D) for v in levels], dim=1)
    c, k, lg, reg = port._energy_refine(
        *(torch.from_numpy(a) for a in (corners, kpts, logits, qpos, refs)), value, SHAPES,
        None)
    loss_t = (k ** 2).sum() + (c ** 2).mean() + lg.sum() + reg
    np.testing.assert_allclose(reg.item(), float(reg_j), rtol=1e-4)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    loss_t.backward()
    want = from_jax_variables({"params": grads_j})
    for name, p in port.named_parameters():
        if name in want:
            _close(p.grad, want[name].numpy(), 1e-4)


# ---------------------------------------------------------------- ResNet

def test_resnet50_matches_jax():
    jm = JResNet(depth=50)
    x = np.random.default_rng(12).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    variables = random_variables(template, seed=13)
    want = jm.apply(variables, jnp.asarray(x))
    port = load_port(ResNet(50), {c: {"backbone": t} for c, t in variables.items()},
                     "backbone.")
    with torch.no_grad():
        got = port(_nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 512, 8, 8), (2, 1024, 4, 4), (2, 2048, 2, 2)]
    for g, w in zip(got, want):
        _close(_nhwc(g), w, 1e-4)


def test_resnet_freeze_labels_match_jax():
    # the reference ResNet's freeze (stem and layer1), JAX's optimiser labels
    model = jax_build_model(jax_model_config("s", backbone_name="resnet50"))
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    params = random_variables(template, seed=15)["params"]
    freeze_at, stem_only = resolve_backbone_freeze("resnet50")
    tx = jax_make_optimizer(params, freeze_at=freeze_at, freeze_stem_only=stem_only)
    grads = jax.tree.map(jnp.ones_like, params)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    moved = {k: bool(np.abs(v.numpy()).max() > 0) for k, v in
             from_jax_variables({"params": jax.tree.map(np.asarray, updates)}).items()}
    port = build_model(model_config("s", backbone_name="resnet50"), device="cpu")
    labels = label_parameters(port, freeze_at=freeze_at, freeze_stem_only=stem_only)
    assert labels.keys() == moved.keys()
    for name, label in labels.items():
        assert (label != "frozen") == moved[name], (name, label)
    assert labels["backbone.layer1_0.conv1.weight"] == "frozen"
    assert labels["backbone.layer2_0.conv1.weight"] == "backbone"


# ---------------------------------------------------------------- the weight carry

@pytest.mark.parametrize("size,flags", [
    ("n", dict(BRANCHES["everything"], use_kan=True, use_energy_refinement=True)),
    ("s", dict(backbone_name="resnet50")),
    ("n", dict(use_energy_refinement=True, grad_energy=True, use_grid_attention=True,
               grid_num_points=4, use_grid_fusion=False))])
def test_variant_leaves_roundtrip_exact(size, flags):
    # JAX leaves -> port state_dict -> JAX's converter -> the same leaves, bit
    # for bit: every new leaf's name, shape and layout
    model = jax_build_model(jax_model_config(size, **flags))
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    variables = random_variables(template, seed=14)
    port = build_model(model_config(size, **flags), device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)
    back = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                              dict(template))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


def test_deploy_carries_the_variant_leaves():
    # fuse_for_deploy folds the encoder only and carries every other leaf
    # across (JAX utils/deploy.py:40); the deploy form answers as the train form
    flags = dict(BRANCHES["everything"], use_kan=True, use_energy_refinement=True,
                 energy_steps=1)
    train = build_model(model_config("n", **flags), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():   # a well-defined top-60 (tests/test_torch_e2e.py)
        train.transformer.enc_out_class_embed.weight.mul_(50.0)
    sd = train.state_dict()
    fused = fuse_for_deploy(sd)
    for k, v in sd.items():
        if not k.startswith("encoder."):
            assert torch.equal(fused[k], v), k
    deploy = build_model(model_config("n", **flags), deploy=True, device="cpu")
    deploy.load_state_dict(fused, strict=True)
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, got = train(x), deploy(x)
    for k in ("pred_logits", "pred_keypoints"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4)
