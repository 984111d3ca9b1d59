"""Builds and loads the port's CUDA kernels (``csrc/*.cu``) as one shared library.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a plain-C-interface
shared library under ``future_urban_scene_generation_tpu_torch/_build/`` at first
use, named by a hash of the sources and flags (a changed source rebuilds), and bound
with ctypes. A missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster.cu", "stem_conv.cu")
HEADERS = ("fusg_kernels.h",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
BUILD_LOG = ""
BUILD_SECONDS = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for the current sources is missing;
    return its path. Records the compiler's output in ``BUILD_LOG`` and the
    build time in ``BUILD_SECONDS`` (0 when the library already existed)."""
    global BUILD_LOG, BUILD_SECONDS
    out = BUILD_DIR / f"libfusg_kernels_{_digest()}.so"
    if out.exists():
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load():
    """The ctypes handle of the kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fusg_raster.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.fusg_raster.restype = i
    lib.fusg_stem_conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.fusg_stem_conv.restype = i
    _LIB = lib
    return lib
