"""Build and load the evaluator's greedy match (``csrc/coco_match.cc``).

The port's copy of ``detrpose_tpu/utils/native.py``: host code, not a TPU
kernel, so it has no CUDA counterpart. ``g++ -O2 -shared`` builds the
package's own source at first use into ``detrpose_tpu_torch/_build/`` (the
library's name carries a hash of the source, and the write is atomic, so two
processes building at once never load half a library), and ``ctypes`` loads
it. Where no compiler or no build works, ``match_image_native`` returns False
and the evaluator runs its Python loop, which computes the same match.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "coco_match.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


class _Match:
    """The loaded ``match_image`` entry point, built once per process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.fn: Optional[ctypes._CFuncPtr] = None
        self.tried = False
        self.error = ""


_MATCH = _Match()


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libcoco_match_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so_path


def get_match_fn():
    """The native ``match_image``, or None when it cannot be built here
    (``native_error()`` says why)."""
    with _MATCH.lock:
        if not _MATCH.tried:
            _MATCH.tried = True
            try:
                fn = ctypes.CDLL(str(_build())).match_image
            except (OSError, subprocess.SubprocessError) as e:
                _MATCH.error = f"{type(e).__name__}: {e}"
            else:
                fn.restype = None
                fn.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_uint8),
                ]
                _MATCH.fn = fn
        return _MATCH.fn


def native_error() -> str:
    """Why the native match could not be built ("" if it was, or if no build
    was tried yet)."""
    return _MATCH.error


def match_image_native(ious, thrs, gt_ignore, gt_iscrowd, gtm, dtm, dt_ignore) -> bool:
    """Run the native match in place on the numpy arrays ``gtm`` (T, G),
    ``dtm`` (T, D) int64 and ``dt_ignore`` (T, D) uint8, given ``ious``
    (D, G) and the thresholds (T,). Returns False, touching nothing, when the
    library is unavailable (the caller then runs the Python loop)."""
    fn = get_match_fn()
    if fn is None:
        return False
    T, G = gtm.shape
    D = dtm.shape[1]
    ious = np.ascontiguousarray(ious, np.float64)
    thrs = np.ascontiguousarray(thrs, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    gt_iscrowd = np.ascontiguousarray(gt_iscrowd, np.uint8)
    if ious.shape != (D, G) or thrs.shape != (T,) or gt_ignore.shape != (G,) \
            or gt_iscrowd.shape != (G,) or dt_ignore.shape != (T, D):
        raise ValueError("match_image_native: inconsistent shapes")
    for a, dt in ((gtm, np.int64), (dtm, np.int64), (dt_ignore, np.uint8)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError(f"match_image_native: outputs must be C-contiguous {dt.__name__}")

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    fn(T, D, G, p(ious, ctypes.c_double), p(thrs, ctypes.c_double),
       p(gt_ignore, ctypes.c_uint8), p(gt_iscrowd, ctypes.c_uint8),
       p(gtm, ctypes.c_int64), p(dtm, ctypes.c_int64), p(dt_ignore, ctypes.c_uint8))
    return True
