"""The benchmark's plain reference of DETRPose's serving forward and its
top-k decode, in plain PyTorch and float32 (TF32 off while it runs), MSDA
by ``F.grid_sample``.

A frozen copy of the model code the benchmark measures, kept apart so that a
later change to the program does not move it. It imports nothing of the
program and takes none of its weights: ``build`` makes the modules from a
configuration file's ``model`` block, and the benchmark loads the weights it
draws from the seed (``h100_bench/weights.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .models.decoder import MSDA_BRANCHES
from .models.detrpose import DETRPose
from .models.hgnetv2 import HGNetv2
from .models.hybrid_encoder import HybridEncoder
from .models.transformer import Transformer

# the keys of a ``model`` block that ``build`` reads: every configuration
# states the first; the variants (the experimental MSDA branches, FastKAN,
# energy refinement) take the reference's defaults where a block leaves them out
REQUIRED = ("num_body_points", "num_classes", "num_queries", "backbone_name", "use_lab",
            "return_idx", "in_channels", "n_levels", "hidden_dim", "enc_dim_feedforward",
            "use_encoder_idx", "expansion", "depth_mult", "num_decoder_layers",
            "dec_dim_feedforward", "dec_n_points", "reg_max", "reg_scale")
VARIANTS = MSDA_BRANCHES + ("use_kan", "kan_grid", "use_energy_refinement", "energy_steps",
                            "energy_step_size", "grad_energy", "energy_decrease_weight")


def build(model: Dict[str, Any], device: torch.device | str = "cpu") -> DETRPose:
    """DETRPose in eval mode and float32 on ``device`` from the ``model``
    block of a configuration file; its weights are torch's defaults until
    the caller loads others."""
    with torch.device(device):
        backbone = HGNetv2(arch=model["backbone_name"], use_lab=model["use_lab"],
                           return_idx=tuple(model["return_idx"]))
        encoder = HybridEncoder(
            in_channels=tuple(model["in_channels"]), n_levels=model["n_levels"],
            hidden_dim=model["hidden_dim"], dim_feedforward=model["enc_dim_feedforward"],
            use_encoder_idx=tuple(model["use_encoder_idx"]), expansion=model["expansion"],
            depth_mult=model["depth_mult"])
        transformer = Transformer(
            hidden_dim=model["hidden_dim"], num_queries=model["num_queries"],
            num_decoder_layers=model["num_decoder_layers"],
            dim_feedforward=model["dec_dim_feedforward"], num_feature_levels=model["n_levels"],
            dec_n_points=model["dec_n_points"], num_classes=model["num_classes"],
            num_body_points=model["num_body_points"], reg_max=model["reg_max"],
            reg_scale=model["reg_scale"], **{k: model[k] for k in VARIANTS if k in model})
        net = DETRPose(backbone, encoder, transformer)
    return net.float().eval()
