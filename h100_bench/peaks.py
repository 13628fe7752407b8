"""The published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name`` gives. NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full power limit of 700 W.

A card missing from the table fails the run: no peak is guessed.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flop_per_s": 989e12,     # tensor cores, dense
        "f32_flop_per_s": 67e12,       # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(device_name: str) -> dict:
    """The peaks of ``device_name``; raises ``LookupError`` for a card the
    table does not hold."""
    if device_name not in PEAKS:
        raise LookupError(f"no published peak for {device_name!r} in h100_bench/peaks.py; "
                          f"known: {sorted(PEAKS)}")
    return PEAKS[device_name]
