"""Wrappers of the hand-written CUDA kernels in ``detrpose_tpu_torch/csrc``.

Each kernel is built with ``nvcc`` at its first launch (``build.py``); importing
these modules builds nothing. Importing them registers the kernels' custom ops
(``torch.ops.detrpose_tpu_torch.*``), which a program saved by
``tools/export.py`` needs before it is loaded.
"""
from .msda import ms_deform_attn_fast, ms_deform_attn_fast_flat, msda_forward
from .msda_perquery import (ms_deform_attn_pallas, ms_deform_attn_pallas_flat,
                            msda_perquery)

KERNELS = {"msda_fwd": msda_forward, "msda_perquery": msda_perquery}

__all__ = ["KERNELS", "ms_deform_attn_fast", "ms_deform_attn_fast_flat",
           "ms_deform_attn_pallas", "ms_deform_attn_pallas_flat", "msda_forward",
           "msda_perquery"]
