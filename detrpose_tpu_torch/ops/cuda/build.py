"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel is a plain C entry point compiled by ``nvcc`` for ``sm_90a``
(Hopper) into ``detrpose_tpu_torch/_build/`` and loaded with ``ctypes``. The
build happens at first use, from the package's own sources; the library's
name carries a hash of the source, the headers beside it and the flags, so an
edited source or header is rebuilt and never mixed up with an old build.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class _Loaded:
    """Libraries built and loaded in this process, by source name. Each
    source has its own lock, so two sources build at the same time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.source_locks: Dict[str, threading.Lock] = {}
        self.libs: Dict[str, Tuple[ctypes.CDLL, str]] = {}

    def source_lock(self, source: str) -> threading.Lock:
        with self.lock:
            return self.source_locks.setdefault(source, threading.Lock())


_LOADED = _Loaded()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def source_digest(src: Path) -> str:
    """Hash of ``src``, every ``*.cuh`` header in its directory and the nvcc
    flags: what the library built from ``src`` depends on."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(source: str) -> Tuple[ctypes.CDLL, str]:
    """Build ``csrc/<source>`` if needed and return (library, compiler log).

    The log holds nvcc's ``-Xptxas -v`` report (registers, shared memory,
    spills per kernel) when this call built the library, else "".
    """
    with _LOADED.source_lock(source):
        if source in _LOADED.libs:
            return _LOADED.libs[source]
        src = CSRC / source
        lib_path = BUILD_DIR / f"lib{src.stem}_{source_digest(src)}.so"
        log = ""
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
                log = proc.stderr
                os.replace(tmp, lib_path)   # atomic: no half-written library
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(lib_path))
        _LOADED.libs[source] = (lib, log)
        return lib, log
