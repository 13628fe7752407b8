"""The weights of a run, drawn from its seed on the device in one call.

One standard-normal draw of every floating leaf of the model, from a
``torch.Generator`` on the run's device seeded with ``--seed``, cut into the
leaves in name order and shaped per leaf by its role:

- kernels (two dimensions or more): scaled to std 1/sqrt(fan_in), as a
  trained network's weights keep activations at unit scale;
- scales (a norm's ``weight``, a learnable affine ``scale``): 1 + 0.1 z;
- a learnable step size (a leaf named ``*step_size``, energy refinement's):
  the configuration's ``energy_step_size`` x (1 + 0.1 z), positive and near
  its configured value, as descent needs;
- biases and running means: 0.1 z; running variances: exp(0.2 z).

Every leaf is drawn, none is left at a constructor's value, so the zero
heads and the bias priors of a fresh init do not make the outputs flat.
The same seed on the same device gives the same weights, so the benchmark
draws them once for the program and again, after the window, for the
reference.
"""
from __future__ import annotations

from typing import Dict

import torch


def draw(shapes: Dict[str, torch.Size], seed: int, device: torch.device | str,
         model: dict) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for the leaves ``shapes`` of the
    configuration whose ``model`` block is ``model``."""
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, z in zip(names, flat.split(sizes)):
        shape = torch.Size(shapes[name])
        leaf = name.rsplit(".", 1)[-1]
        z = z.view(shape)
        if len(shape) >= 2:
            w = z * (shape[0] / z.numel()) ** 0.5
        elif leaf in ("weight", "scale"):
            w = 1.0 + 0.1 * z
        elif leaf.endswith("step_size"):
            w = model["energy_step_size"] * (1.0 + 0.1 * z)
        elif leaf == "running_var":
            w = torch.exp(0.2 * z)
        else:                                   # biases, running means
            w = 0.1 * z
        out[name] = w
    return out


def leaf_shapes(model: torch.nn.Module) -> Dict[str, torch.Size]:
    """The floating leaves of ``model``'s state_dict and their shapes."""
    return {k: v.shape for k, v in model.state_dict().items() if v.is_floating_point()}


def reference_net(model: dict, seed: int, device):
    """The reference built from a configuration's ``model`` block on
    ``device`` with the seed's weights."""
    from .reference import build

    net = build(model, device)
    net.load_state_dict(draw(leaf_shapes(net), seed, device, model), strict=True)
    return net

