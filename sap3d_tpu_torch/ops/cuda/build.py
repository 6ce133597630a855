"""Build the port's CUDA sources into shared libraries and load them.

Each ``sap3d_tpu_torch/csrc/<name>.cu`` has a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repo root
(git-ignored) at first use, and loaded with ``ctypes``.  The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused.  Nothing is built at import time: the CPU
tests import every module on a host without ``nvcc``.

Missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from csrc/ at first use")
    return nvcc


def _library_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    compiler's output (register and shared-memory use from ``-Xptxas -v``;
    empty when the library was already built)."""
    src, lib = _library_path(name)
    if os.path.exists(lib):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    out = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, check=False)
    log = out.stdout + out.stderr
    if out.returncode:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a reader never sees half a file
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(_library_path(name)[1])
        return _loaded[name]
