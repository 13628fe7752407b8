"""Wrappers of the hand-written CUDA kernels in ``detrpose_tpu_torch/csrc``.

Each kernel is built with ``nvcc`` at its first launch (``build.py``); importing
these modules builds nothing. Importing them registers the kernels' custom ops
(``torch.ops.detrpose_tpu_torch.*``), which a program saved by
``tools/export.py`` needs before it is loaded.
"""
from .kan import kan_basis
from .msda import ms_deform_attn_fast, ms_deform_attn_fast_flat, msda_forward
from .msda_ablate import msda_ablate
from .msda_colsin import ms_deform_attn_colsin, msda_colsin
from .msda_perquery import (ms_deform_attn_pallas, ms_deform_attn_pallas_flat,
                            msda_perquery)
from .msda_tpose import ms_deform_attn_tpose, msda_tpose

KERNELS = {"msda_fwd": msda_forward, "msda_perquery": msda_perquery,
           "msda_colsin": msda_colsin, "msda_tpose": msda_tpose, "msda_ablate": msda_ablate}

__all__ = ["KERNELS", "kan_basis", "ms_deform_attn_colsin", "ms_deform_attn_fast",
           "ms_deform_attn_fast_flat", "ms_deform_attn_pallas", "ms_deform_attn_pallas_flat",
           "ms_deform_attn_tpose", "msda_ablate", "msda_colsin", "msda_forward",
           "msda_perquery", "msda_tpose"]
