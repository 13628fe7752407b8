"""Model-zoo presets (N/S/M/L/X x {COCO 17, CrowdPose 14 keypoints}).

Counterpart of ``detrpose_tpu/configs/presets.py``, with its own copy of the
size table; it mirrors the reference config deltas
(configs/detrpose/detrpose_hgnetv2_{n,s,m,l,x}.py on top of
include/detrpose_hgnetv2.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..models import DETRPose, HGNetv2, HybridEncoder, Transformer
from ..models.decoder import MSDA_BRANCHES
from ..models.detrpose import init_parameters
from ..models.resnet import ResNet
from ..utils.device import resolve_device


@dataclasses.dataclass
class ModelConfig:
    size: str = "l"
    num_body_points: int = 17
    num_classes: int = 2
    num_queries: int = 60
    eval_spatial_size: Sequence[int] = (640, 640)  # (h, w)
    # backbone
    backbone_name: str = "B4"
    use_lab: bool = False
    return_idx: Sequence[int] = (1, 2, 3)
    # encoder
    in_channels: Sequence[int] = (512, 1024, 2048)
    feat_strides: Sequence[int] = (8, 16, 32)
    n_levels: int = 3
    hidden_dim: int = 256
    enc_dim_feedforward: int = 1024
    use_encoder_idx: Sequence[int] = (2,)
    expansion: float = 1.0
    depth_mult: float = 1.0
    # transformer
    num_decoder_layers: int = 6
    dec_dim_feedforward: int = 1024
    dec_n_points: int = 4
    reg_max: int = 32
    reg_scale: float = 4.0
    # experimental decoder branches of the reference (models/decoder.py)
    use_modulation: bool = False
    use_region_sampling: bool = False
    region_kernel_size: int = 1
    use_global_context: bool = False
    use_grouped_offsets: bool = False
    num_groups: int = 1
    use_grid_attention: bool = False
    grid_num_points: int = 16
    use_grid_offsets: bool = False
    use_grid_fusion: bool = True
    # MSDA compute path (the JAX names; models/decoder.py::MSDeformAttn):
    #   "auto", "sep"  CUDA kernel #1 (csrc/msda_fwd.cu)
    #   "pallas"       CUDA kernel #2 (csrc/msda_perquery.cu)
    #   "gather"       the plain PyTorch version on any device
    # On a CPU tensor each kernel's wrapper runs its plain version.
    msda_backend: str = "auto"
    use_kan: bool = False
    kan_grid: int = 3
    use_energy_refinement: bool = False
    energy_steps: int = 3
    energy_step_size: float = 0.1
    grad_energy: bool = False
    energy_decrease_weight: float = 0.0
    # recompute each backbone stage and decoder layer in the backward pass of
    # training (torch.utils.checkpoint; the JAX knob, presets.py:74)
    remat: bool = False
    dtype: torch.dtype = torch.float32


_SIZE_OVERRIDES = {
    "n": dict(
        backbone_name="B0", use_lab=True, return_idx=(2, 3),
        in_channels=(512, 1024), feat_strides=(16, 32), n_levels=2,
        use_encoder_idx=(1,), depth_mult=0.5, expansion=0.34,
        hidden_dim=128, enc_dim_feedforward=512,
        num_decoder_layers=3, dec_dim_feedforward=512, dec_n_points=6,
    ),
    "s": dict(
        backbone_name="B0", use_lab=True,
        in_channels=(256, 512, 1024), depth_mult=0.34, expansion=0.5,
        num_decoder_layers=3,
    ),
    "m": dict(
        backbone_name="B2", use_lab=True,
        in_channels=(384, 768, 1536), depth_mult=0.67,
        num_decoder_layers=4,
    ),
    "l": dict(),
    "x": dict(
        backbone_name="B5",
        hidden_dim=384, enc_dim_feedforward=2048, reg_scale=8.0,
    ),
}


def model_config(size: str = "l", num_body_points: int = 17, **overrides) -> ModelConfig:
    cfg = ModelConfig(size=size, num_body_points=num_body_points)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    for k, v in _SIZE_OVERRIDES[size].items():
        setattr(cfg, k, v)
    for k, v in overrides.items():
        if k not in known:
            raise TypeError(f"unknown ModelConfig override: {k!r}")
        setattr(cfg, k, v)
    # ResNet alternative backbone: its C3/C4/C5 channels are fixed
    if cfg.backbone_name.startswith("resnet") and "in_channels" not in overrides:
        cfg.in_channels = (512, 1024, 2048)
    return cfg


def build_model(cfg: ModelConfig, deploy: bool = False,
                device: torch.device | str = "cuda",
                generator: Optional[torch.Generator] = None) -> DETRPose:
    """Build the model in eval mode on ``device``, in ``cfg.dtype``, with weights
    drawn from ``generator`` (a CPU generator seeded with 0 if None); the
    caller calls ``.train()`` for the training forward.

    ``deploy=True`` builds the encoder's re-parameterised form, which takes
    the weights ``utils/deploy.py::fuse_for_deploy`` makes from the train
    form's state_dict.
    """
    dev = resolve_device(device)
    if cfg.backbone_name.startswith("resnet"):
        backbone = ResNet(depth=int(cfg.backbone_name[len("resnet"):]), return_idx=(1, 2, 3))
    else:
        backbone = HGNetv2(arch=cfg.backbone_name, use_lab=cfg.use_lab,
                           return_idx=tuple(cfg.return_idx), remat=cfg.remat)
    encoder = HybridEncoder(
        in_channels=tuple(cfg.in_channels), n_levels=cfg.n_levels, hidden_dim=cfg.hidden_dim,
        dim_feedforward=cfg.enc_dim_feedforward,
        use_encoder_idx=tuple(cfg.use_encoder_idx),
        expansion=cfg.expansion, depth_mult=cfg.depth_mult, deploy=deploy)
    transformer = Transformer(
        hidden_dim=cfg.hidden_dim, num_queries=cfg.num_queries,
        num_decoder_layers=cfg.num_decoder_layers,
        dim_feedforward=cfg.dec_dim_feedforward,
        num_feature_levels=cfg.n_levels, dec_n_points=cfg.dec_n_points,
        num_classes=cfg.num_classes, num_body_points=cfg.num_body_points,
        reg_max=cfg.reg_max, reg_scale=cfg.reg_scale, msda_backend=cfg.msda_backend,
        remat=cfg.remat, use_kan=cfg.use_kan, kan_grid=cfg.kan_grid,
        use_energy_refinement=cfg.use_energy_refinement, energy_steps=cfg.energy_steps,
        energy_step_size=cfg.energy_step_size, grad_energy=cfg.grad_energy,
        energy_decrease_weight=cfg.energy_decrease_weight,
        **{k: getattr(cfg, k) for k in MSDA_BRANCHES})
    model = DETRPose(backbone, encoder, transformer)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(device=dev, dtype=cfg.dtype).eval()
