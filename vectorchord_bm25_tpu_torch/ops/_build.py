"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The library lands in ``_build/`` beside the package,
named by a hash of the sources and flags, so a second process reuses it
and an edited source rebuilds.  Nothing here runs at import time: the
first CUDA launch calls ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["library", "nvcc_path", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``; raises if neither
    has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of vectorchord_bm25_tpu_torch need the CUDA toolkit"
    )


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _tag(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.bm25_fused_range_scores
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
    fn.restype = i


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    path = os.path.join(_BUILD, f"libbm25_kernels_{_tag(sources)}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        # Build to a private name, then rename: concurrent builders never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return lib
