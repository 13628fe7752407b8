"""Deploy-time re-parameterisation as a pure state_dict transform.

Counterpart of ``detrpose_tpu/utils/deploy.py::fuse_for_deploy``. Reference
semantics: hybrid_encoder.py ``ConvNormLayer_fuse.convert_to_deploy``
(:80-111) and ``VGGBlock.convert_to_deploy`` (:156-189): conv+BN folding and
the 3x3 + 1x1 branch merge. The reference mutates modules; here the train
form's state_dict is turned into the one the ``deploy=True`` modules take
(``configs/presets.py::build_model(cfg, deploy=True)``):

  model_dep = build_model(cfg, deploy=True)
  model_dep.load_state_dict(fuse_for_deploy(model.state_dict()), strict=True)

It fuses exactly the JAX set: the encoder's ``ConvNormLayerFuse`` modules
(``cv1``, ``cv2``, ``cv4`` and ``cv2_conv``/``cv3_conv``, which the state_dict
names ``cv2.1``/``cv3.1``) and the VGG bottlenecks. The backbone's BatchNorms
stay, as in JAX. Weights are OIHW: the BN scale lies on dim 0 (a depthwise
``SCDown.cv2`` weight is ``(O, 1, k, k)``), and the 1x1 branch is padded into
the centre ``[..., 1:2, 1:2]`` of the 3x3. The fold runs in float32 whatever
the input's dtype; the result is float32, cast by ``load_state_dict``.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import torch

EPS = 1e-5
# '<prefix>.conv.weight' of an encoder ConvNormLayerFuse
_FUSE_KEY = re.compile(r"^(encoder\..*\.(?:cv1|cv2|cv4|cv2\.1|cv3\.1))\.conv\.weight$")
# '<prefix>.conv1.conv.weight' of a VGG bottleneck
_VGG_KEY = re.compile(r"^(.*\.bottlenecks\.\d+)\.conv1\.conv\.weight$")
_BN = ("weight", "bias", "running_mean", "running_var")


def _fold(sd: Mapping[str, torch.Tensor], conv: str, norm: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the eval BatchNorm ``norm`` into the bias-free conv ``conv``
    -> (weight', bias'), float32."""
    gamma, beta, mean, var = (sd[f"{norm}.{n}"].float() for n in _BN)
    t = gamma / torch.sqrt(var + EPS)
    return sd[f"{conv}.weight"].float() * t.reshape(-1, 1, 1, 1), beta - mean * t


def fuse_for_deploy(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Train-form state_dict -> deploy-form state_dict (a new dict; the input
    is not changed). The running statistics of fused modules are dropped."""
    fused: Dict[str, torch.Tensor] = {}
    consumed = set()
    for key in state_dict:
        m = _FUSE_KEY.match(key)
        if m:
            p = m.group(1)
            fused[f"{p}.conv_bn_fused.weight"], fused[f"{p}.conv_bn_fused.bias"] = _fold(
                state_dict, f"{p}.conv", f"{p}.norm")
            consumed.update([f"{p}.conv.weight"] + [f"{p}.norm.{n}" for n in _BN])
            continue
        m = _VGG_KEY.match(key)
        if m:
            p = m.group(1)
            k3, b3 = _fold(state_dict, f"{p}.conv1.conv", f"{p}.conv1.norm")
            k1, b1 = _fold(state_dict, f"{p}.conv2.conv", f"{p}.conv2.norm")
            if k3.shape[-2:] != (3, 3) or k1.shape[-2:] != (1, 1):
                raise ValueError(f"{p}: expected a 3x3 and a 1x1 branch, got "
                                 f"{tuple(k3.shape)} and {tuple(k1.shape)}")
            k3[..., 1:2, 1:2] += k1   # the 1x1 padded into the 3x3 centre
            fused[f"{p}.conv.weight"], fused[f"{p}.conv.bias"] = k3, b3 + b1
            consumed.update(f"{p}.{branch}.{leaf}" for branch in ("conv1", "conv2")
                            for leaf in ["conv.weight"] + [f"norm.{n}" for n in _BN])
    out: Dict[str, torch.Tensor] = OrderedDict()
    for key, v in state_dict.items():
        if key not in consumed:
            out[key] = v
    out.update(fused)
    return out
