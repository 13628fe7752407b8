"""Weights across frameworks: JAX variables -> this package's state_dict, and
the reference's zoo ``.pth`` files.

``from_jax_variables`` is the inverse of ``detrpose_tpu/utils/convert.py``
(flax path -> torch key rewrites, conv HWIO <-> OIHW, Dense transpose, packed
attention q/k/v, the scanned decoder stack). This module keeps its own copy of
those rules: the port imports nothing of the JAX package. The model
variants' leaves (the MSDeformAttn branches', FastKAN's, the energy layer's,
``energy_step_size``, the ResNet's ``conv1``, ``bn1.bn``, ``layer{s}_{b}``)
take the same rules; the port's modules carry their names.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

# Ordered path rewrites, applied to the '/'-joined flax path before the leaf.
_REWRITES = [
    (r"transformer/decoder/class_head_(\d+)", r"transformer/class_embed.\1"),
    (r"transformer/decoder/pose_head_(\d+)", r"transformer/pose_embed.\1"),
    (r"transformer/decoder/lqe_head_(\d+)", r"transformer/lqe_embed.\1"),
    (r"transformer/decoder/pre_pose_head", r"transformer/pre_pose_embed"),
    (r"input_proj_(\d+)_conv", r"input_proj.\1.conv"),
    (r"input_proj_(\d+)_norm", r"input_proj.\1.norm"),
    (r"encoder_(\d+)_layers_(\d+)", r"encoder.\1.layers.\2"),
    (r"downsample_convs_(\d+)", r"downsample_convs.\1.0"),
    (r"agg_squeeze", r"aggregation.0"),
    (r"agg_excite", r"aggregation.1"),
    (r"agg_conv", r"aggregation.0"),
    (r"agg_ese", r"aggregation.1"),
    (r"cv2_csp", r"cv2.0"),
    (r"cv2_conv", r"cv2.1"),
    (r"cv3_csp", r"cv3.0"),
    (r"cv3_conv", r"cv3.1"),
    (r"(stages|blocks|layers|bottlenecks|fpn_blocks|pan_blocks|lateral_convs)_(\d+)",
     r"\1.\2"),
]

# Raw embedding params (flax self.param leaves -> nn.Embedding.weight).
_EMBED_LEAVES = ("tgt_embed", "keypoint_embedding", "instance_embedding",
                 "label_enc", "pose_enc")

# The flax decoder runs its layers under nn.scan ("dec_scan"): each leaf has a
# leading num_layers axis; torch has one module per layer.
_SCAN_CHILDREN = {
    "layer": "layers_{i}",
    "pose_head": "pose_head_{i}",
    "class_head": "class_head_{i}",
    "lqe_head": "lqe_head_{i}",
}

# Tensors of a reference checkpoint that this package recomputes or never
# reads (BatchNorm counters, eval-size anchor buffers, FDR constants).
DERIVED_KEY_PARTS = (
    "num_batches_tracked", "anchors", "valid_mask", "dim_t", ".up", ".reg_scale",
    "layer_loss", "project", "_base_grid_placeholder",
)


def _flax_path_to_torch_key(path: Tuple[str, ...], collection: str) -> str:
    """Map a flax variable path to the torch state_dict key."""
    *names, leaf = path
    s = "/".join(names)
    for pat, rep in _REWRITES:
        s = re.sub(pat, rep, s)
    key = s.replace("/", ".")

    # the flax BatchNorm wrapper '<parent>.norm.bn' is torch '<parent>.bn' in
    # the backbone (ConvBNAct) and '<parent>.norm' elsewhere
    if key.endswith(".norm.bn"):
        base = key[: -len(".norm.bn")]
        key = base + (".bn" if key.startswith("backbone.") else ".norm")

    if collection == "batch_stats":
        leaf_name = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf in _EMBED_LEAVES:
        leaf_name = f"{leaf}.weight"
    else:
        leaf_name = {
            "kernel": "weight", "scale": "weight", "bias": "bias",
            "embedding": "weight", "weight": "weight",
            "lab_scale": "lab.scale", "lab_bias": "lab.bias",
        }.get(leaf, leaf)
    return f"{key}.{leaf_name}" if key else leaf_name


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _unstack(path: Tuple[str, ...], arr: np.ndarray):
    """Split a scanned-decoder leaf into per-layer (path, array) pairs."""
    *names, leaf = path
    if "dec_scan" not in names:
        yield path, arr
        return
    si = names.index("dec_scan")
    child = _SCAN_CHILDREN[names[si + 1]]
    for i in range(arr.shape[0]):
        yield (tuple(names[:si]) + (child.format(i=i),) + tuple(names[si + 2:])
               + (leaf,)), arr[i]


def from_jax_variables(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{'params', 'batch_stats'}`` tree -> this package's state_dict.

    Conv kernels go HWIO -> OIHW (depthwise too), Dense kernels are
    transposed, attention q/k/v projections are packed into
    ``in_proj_weight``/``in_proj_bias``, the scanned decoder stack is split
    into per-layer keys, and BatchNorm ``mean``/``var`` become
    ``running_mean``/``running_var``. All tensors are float32.
    """
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[str, list] = {}
    for coll, tree in variables.items():
        for stacked_path, stacked in _leaves(tree):
            for path, arr in _unstack(stacked_path, stacked):
                leaf = path[-1]
                if coll != "params":
                    sd[_flax_path_to_torch_key(path, coll)] = arr
                    continue
                m = re.search(r"(q_proj|k_proj|v_proj)", "/".join(path))
                if m and "attn" in "/".join(path):
                    base = _flax_path_to_torch_key(
                        path[: path.index(m.group(1))] + ("_",), "params")[:-2]
                    name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
                    parts = qkv.setdefault(f"{base}.{name}", [None, None, None])
                    parts[("q_proj", "k_proj", "v_proj").index(m.group(1))] = (
                        arr.T if leaf == "kernel" else arr)
                    continue
                if leaf == "kernel":
                    arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                sd[_flax_path_to_torch_key(path, "params")] = arr
    for key, parts in qkv.items():
        sd[key] = np.concatenate(parts, axis=0)
    return OrderedDict((k, torch.tensor(v)) for k, v in sd.items())


def _nodes(tree: Any) -> Iterator[Mapping[str, Any]]:
    """Every mapping in a restored tree of dicts and lists, depth first."""
    if isinstance(tree, Mapping):
        yield tree
        for v in tree.values():
            yield from _nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _nodes(v)


def _one(tree: Any, fields: set, what: str) -> Mapping[str, Any]:
    found = [d for d in _nodes(tree) if set(d) == fields]
    if len(found) != 1:
        raise ValueError(f"optax state: {len(found)} {what} ({sorted(fields)}) where one "
                         f"was expected")
    return found[0]


def _present(tree: Any) -> Any:
    """The tree without the leaves a restore gives masked nodes (None, empty
    containers), so it holds only one label's parameters."""
    if isinstance(tree, Mapping):
        kept = {k: _present(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None}
    if tree is None or (isinstance(tree, (list, tuple)) and not tree):
        return None
    return tree


def _port_tree(tree: Any) -> Dict[str, torch.Tensor]:
    """A params-shaped numpy tree in the port's layout (``from_jax_variables``:
    kernels transposed, q/k/v packed, the scanned decoder split)."""
    kept = _present(tree)
    return dict(from_jax_variables({"params": kept})) if kept else {}


def optimizer_from_optax(opt_state: Any) -> Dict[str, Any]:
    """The optimiser fields of this package's checkpoint from the optax state
    of JAX ``make_optimizer``'s transform (``detrpose_tpu/train/optim.py``),
    restored as numpy by ``PyTreeCheckpointer().restore`` with no template.

    Such a restore gives named tuples back as dicts of their fields and
    tuples as lists; the masked nodes of ``multi_transform`` (the leaves
    outside a label) and the empty states come back as None. The transform
    is ``[MultiSteps](chain([scale(k)], [clip_by_global_norm],
    multi_transform({"main", "backbone": adamw, "frozen": set_to_zero})))``,
    so the restored tree reads, found by its fields and not by position:

      {"mini_step", "gradient_step", "acc_grads", "skip_state",
       "inner_opt_state": [None, None,                      (with k > 1)
        {"inner_states": {label: {"inner_state": [
            {"count", "mu", "nu"},       ScaleByAdamState
            None,                        add_decayed_weights
            {"count"}]}}}]}              scale_by_learning_rate's schedule

    (without ``MultiSteps`` the chain's list itself, and without the clip
    one None fewer). Each label's ``mu`` and ``nu`` go through the weight key
    map (``from_jax_variables``), kernels transposed and the scanned decoder
    split as the weights are; a parameter takes its moments from the label
    that holds them, and one in neither "main" nor "backbone" is frozen and
    has no state. Returns:

      optimizer   an ``AdamW.state_dict()`` over the groups "main" and
                  "backbone" in that order, each group holding only its
                  parameters' indices and names (``param_names``): optax's
                  state carries no hyperparameters, and
                  ``utils/checkpoint.py::restore_checkpoint`` maps the groups
                  by name onto ``train/optim.py::make_optimizer``'s and gives
                  them the resuming run's. Each parameter's ``step`` is its label's adam
                  ``count`` (the bias correction's t - 1), ``exp_avg`` and
                  ``exp_avg_sq`` its ``mu`` and ``nu``
      optimizer_updates   the schedule's ``count``, from which
                  ``TrainOptimizer`` takes the learning rate; optax advances
                  it with the adam count, and a state where the two differ
                  raises
      micro, grads   ``MultiSteps``' ``mini_step`` and, when it is above 0,
                  the gradients accumulated so far by name: optax keeps
                  their running mean (``acc_grads``), this package their sum
                  in ``p.grad``, so ``acc_grads * mini_step``; without
                  ``MultiSteps`` 0 and None
    """
    multi = next((d for d in _nodes(opt_state) if "mini_step" in d), None)
    inner = multi["inner_opt_state"] if multi is not None else opt_state
    labels = _one(inner, {"inner_states"}, "multi_transform states")["inner_states"]
    state, groups, owner, updates = {}, [], {}, set()
    for label in ("main", "backbone"):
        if label not in labels:
            continue
        adam = _one(labels[label], {"count", "mu", "nu"}, f'adam states under "{label}"')
        sched = _one(labels[label], {"count"}, f'schedule states under "{label}"')
        count, sched_count = int(np.asarray(adam["count"])), int(np.asarray(sched["count"]))
        if count != sched_count:
            raise ValueError(f'optax state: "{label}" has adam count {count} and schedule '
                             f"count {sched_count}")
        updates.add(count)
        mu, nu = _port_tree(adam["mu"]), _port_tree(adam["nu"])
        if set(mu) != set(nu):
            raise ValueError(f'optax state: "{label}" has moments mu and nu of other leaves')
        names = []
        for name in mu:
            if name in owner:
                raise ValueError(f'optax state: {name} has moments under "{owner[name]}" '
                                 f'and "{label}"')
            owner[name] = label
            state[len(state)] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                 "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            names.append(name)
        if names:
            first = len(state) - len(names)
            groups.append({"params": list(range(first, len(state))), "param_names": names})
    if len(updates) > 1:
        raise ValueError(f"optax state: the labels' counts differ: {sorted(updates)}")
    micro = int(np.asarray(multi["mini_step"])) if multi is not None else 0
    grads = None
    if micro:
        grads = {n: t * np.float32(micro) for n, t in _port_tree(multi["acc_grads"]).items()}
    return {"optimizer": {"state": state, "param_groups": groups},
            "optimizer_updates": updates.pop() if updates else 0,
            "micro": micro, "grads": grads}


def convert_orbax(path: str) -> Dict[str, Any]:
    """The JAX package's orbax checkpoint at ``path`` as a checkpoint dict of
    this package (CPU float32 tensors).

    ``detrpose_tpu/utils/checkpoint.py::save_checkpoint`` writes
    ``{"state": TrainState, "epoch"}``: the TrainState's ``step``,
    ``params``, ``batch_stats``, ``opt_state`` (optax's AdamW) and ``ema``
    (``{"params", "batch_stats", "updates"}``, or None). It is read with
    ``PyTreeCheckpointer().restore`` and no template, and the weights, the
    BatchNorm statistics and the EMA stream go through ``from_jax_variables``
    into the reference's layout that ``utils/checkpoint.py`` writes and reads:

      model       the live weights and statistics
      ema         {"module": the EMA's weights with its own statistics (the
                  live ones when the EMA carries none, as JAX
                  ``restore_variables`` does), "updates": its update count},
                  or None
      optimizer, optimizer_updates, micro, grads   ``optimizer_from_optax``
                  of the ``opt_state``: AdamW's moments and step counts, the
                  schedule's count and the partial accumulation
      step, epoch   the TrainState's step, the epoch

    orbax is imported here only; where it is not installed, convert the
    checkpoint where it is (``tools/convert_orbax.py``) and pass the ``.pth``.
    """
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            f"{path} is a directory, read as an orbax checkpoint of the JAX package, and "
            f"reading it needs the orbax package, which is not installed here. Convert it "
            f"where orbax is installed (python -m detrpose_tpu_torch.tools.convert_orbax "
            f"{path} OUT.pth) and pass OUT.pth instead") from e
    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    rs = raw["state"]
    live = {"params": rs["params"], "batch_stats": rs.get("batch_stats") or {}}
    ema: Optional[dict] = rs.get("ema")
    ema_out = None
    if ema:
        ema_vars = {"params": ema["params"],
                    "batch_stats": ema.get("batch_stats") or live["batch_stats"]}
        ema_out = {"module": dict(from_jax_variables(ema_vars)),
                   "updates": int(np.asarray(ema.get("updates", 0)))}
    return {
        "model": dict(from_jax_variables(live)),
        "ema": ema_out,
        **optimizer_from_optax(rs["opt_state"]),
        "step": int(np.asarray(rs.get("step", 0))),
        "epoch": int(np.asarray(raw.get("epoch", 0))),
    }


def read_checkpoint(path: str) -> Any:
    """What a checkpoint file holds (``torch.load`` onto the CPU), or, for a
    directory, the JAX package's orbax checkpoint there converted in memory
    (``convert_orbax``, which needs orbax)."""
    if os.path.isdir(path):
        return convert_orbax(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Load a reference zoo ``.pth``, a checkpoint of this package's Trainer
    or the JAX package's orbax directory (``read_checkpoint``) into a flat
    state_dict of CPU tensors (the EMA weights when present and
    ``prefer_ema``)."""
    ckpt = read_checkpoint(path)
    if isinstance(ckpt, dict):
        if prefer_ema and "ema" in ckpt and ckpt["ema"] is not None:
            sd = ckpt["ema"]["module"]
        elif "model" in ckpt:
            sd = ckpt["model"]
        else:
            sd = ckpt
    else:
        sd = ckpt
    return {k: v.detach().cpu() for k, v in sd.items()}


def load_pretrained_backbone_encoder(sd: Mapping[str, torch.Tensor], model: torch.nn.Module
                                     ) -> Dict[str, torch.Tensor]:
    """Load the backbone and encoder of a reference state_dict into ``model``
    and keep its decoder as initialised (transfer learning); returns what
    was loaded, by key.

    Counterpart of ``detrpose_tpu/utils/convert.py:202-243``; reference
    semantics: ``Trainer.pretrain`` drops the ``decoder.*`` keys of a D-FINE
    checkpoint and loads the rest (src/solver/trainer.py:444-451). Here the
    ``decoder.*`` and ``transformer.*`` keys are dropped, and so are the
    tensors this package recomputes (``DERIVED_KEY_PARTS``); every other key
    must be one of ``model``'s backbone or encoder leaves (BatchNorm
    statistics included) with its shape, and every such leaf must be given:
    a key missing, left over or of another shape raises before anything is
    loaded.
    """
    src = {k: v for k, v in drop_derived(sd).items()
           if not k.startswith(("decoder.", "transformer."))}
    own = {k: v for k, v in drop_derived(model.state_dict()).items()
           if k.startswith(("backbone.", "encoder."))}
    missing = sorted(set(own) - set(src))
    unconsumed = sorted(set(src) - set(own))
    if missing or unconsumed:
        raise KeyError(f"backbone/encoder import: {len(missing)} keys missing, e.g. "
                       f"{missing[:4]}; {len(unconsumed)} keys not in the model, e.g. "
                       f"{unconsumed[:4]}")
    bad = [(k, tuple(src[k].shape), tuple(v.shape)) for k, v in own.items()
           if tuple(src[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"backbone/encoder import: {len(bad)} shapes differ (key, given, "
                         f"model), e.g. {bad[:4]}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(torch.as_tensor(src[k]))
    return {k: src[k] for k in own}


def drop_derived(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state_dict without the tensors this package recomputes
    (``DERIVED_KEY_PARTS``), ready for ``load_state_dict(strict=True)``."""
    return {k: v for k, v in sd.items()
            if not any(k.endswith(s) or s in k for s in DERIVED_KEY_PARTS)}
