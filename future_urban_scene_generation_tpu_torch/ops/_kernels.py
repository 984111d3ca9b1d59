"""Builds and loads the port's CUDA kernels (``csrc/*.cu``) as one shared library.

Three sources hold the counterparts of all five TPU kernel entries of the JAX
package: ``raster.cu`` (K1 ``rasterize_corners`` and K1' ``rasterize_indexed``, two
entries on one pair of kernels, triangle setup and tiles), ``stem_conv.cu`` (K2
``icn_stem_conv``) and ``conv_small_cin.cu`` (K3 ``conv_small_cin_v2`` and K4
``conv_small_cin``, two entries on one kernel); the two conv sources are loaders
around the shared main loops of ``conv_core.cuh``. Two more port no TPU kernel:
``nms.cu`` holds N1, the Mask R-CNN's greedy NMS (the JAX package scans in XLA), and
``conv_int8.cu`` N2, the int8 serving tier's convolution (an int8 XLA conv in the
JAX package). The wrappers and their launch counters are in ``ops/cuda_raster.py``, ``ops/cuda_conv.py`` and
``ops/detection.py``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one process per source in
parallel, and linked into a plain-C-interface shared library under
``future_urban_scene_generation_tpu_torch/_build/`` at first use, named by a hash of
the sources and flags (a changed source rebuilds), and bound with ctypes. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("raster.cu", "stem_conv.cu", "conv_small_cin.cu", "nms.cu", "conv_int8.cu")
HEADERS = ("fusg_kernels.h", "conv_core.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
_LOAD_LOCK = threading.Lock()  # one build, however many threads reach a cold tree
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # One nvcc per source, all started together, then one link.
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / s),
                              "-o", o], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        BUILD_LOG = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        lib = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True,
                              text=True)
        BUILD_LOG += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{BUILD_LOG}")
        os.replace(lib, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load():
    """The ctypes handle of the kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fusg_raster_corners.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.fusg_raster_corners.restype = i
    lib.fusg_raster_indexed.argtypes = [p, p, p, i, i, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.fusg_raster_indexed.restype = i
    lib.fusg_raster_plan.argtypes = [i, i, i, p]
    lib.fusg_raster_plan.restype = i
    lib.fusg_stem_conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.fusg_stem_conv.restype = i
    lib.fusg_conv_small_cin.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.fusg_conv_small_cin.restype = i
    lib.fusg_conv_smem_bytes.argtypes = [i, i, i, i]
    lib.fusg_conv_smem_bytes.restype = i
    lib.fusg_nms.argtypes = [p, p, p, i, ctypes.c_float, ctypes.c_float, i, p, p, p]
    lib.fusg_nms.restype = i
    lib.fusg_nms_smem_bytes.argtypes = [i]
    lib.fusg_nms_smem_bytes.restype = i
    lib.fusg_conv_int8.argtypes = [p, p, p, p] + [i] * 15 + [p]
    lib.fusg_conv_int8.restype = i
    lib.fusg_conv_transpose_int8.argtypes = [p, p, p, p] + [i] * 14 + [p]
    lib.fusg_conv_transpose_int8.restype = i
    return lib
