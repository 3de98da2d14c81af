"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, one process per source,
all started together, then links them into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library lands in ``_build/`` beside the
package, named by a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so a second process
reuses it and an edited source rebuilds; ``ptxas``' register and
shared-memory report for every kernel is kept beside it (``build_log``).
Nothing here runs at import time: the first CUDA launch calls
``library()``.
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

from ..utils import tracing

__all__ = ["library", "build_log", "nvcc_path", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

# Never --use_fast_math: the kernels keep IEEE round-to-nearest division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for path in sources + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    signatures = {
        "bm25_fused_range_scores": [vp, vp, vp, vp, vp, i, i, i, i, ll, i, vp],
        "bm25_tf_range_scores": [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp,
        ],
        "bm25_stream_dense_accumulate": [*([vp] * 10), i, ll, i, i, i, vp],
        "bm25_dense_topk": [*([vp] * 7), i, i, i, i, i, ll, i, vp],
        "bm25_stream_sparse_decode": [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, vp],
        "bm25_sparse_combine": [vp, vp, vp, ll, i, i, i, vp],
        "bm25_stream_rescore_topk": [*([vp] * 13), i, i, i, i, i, vp],
        "bm25_exact_dense_accumulate": [*([vp] * 9), i, i, i, ll, i, i, i, i, vp],
        "bm25_exact_sparse_gather": [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp,
        ],
        "bm25_exact_compact_accumulate": [
            vp, vp, vp, vp, vp, vp, vp, i, i, i, ll, i, i, i, i, i, vp,
        ],
        "bm25_range_bounds": [vp, vp, vp, vp, vp, i, i, i, f, vp],
        "bm25_round_select": [*([vp] * 11), i, i, i, i, i, vp],
        "bm25_round_merge": [*([vp] * 7), i, i, i, i, i, i, vp],
        "bm25_shard_merge": [vp, vp, vp, vp, vp, i, i, i, i, vp],
        "bm25_shard_stats": [vp, vp, vp, vp, vp, vp, i, ll, vp, vp],
        "bm25_posting_sort_census": [*([vp] * 6), i, ll, vp, vp],
        "bm25_posting_sort_passes": [*([vp] * 10), i, i, ll, vp],
        "bm25_stream_sparse_merge": [*([vp] * 12), *([i] * 8), vp],
        "bm25_exact_sparse_merge": [*([vp] * 12), *([i] * 10), vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.bm25_sparse_merge_scratch.argtypes = [i, i, i, i]
    lib.bm25_sparse_merge_scratch.restype = ll


def _compile(sources, workdir):
    """One nvcc per source, all running at once; returns (objects, log)."""
    nvcc = nvcc_path()
    procs = []
    for src in sources:
        obj = os.path.join(workdir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append(
            (src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode})")
    if failed:
        raise RuntimeError(
            "nvcc failed on " + ", ".join(failed) + ":\n" + "\n".join(log)
        )
    return [obj for _, obj, _ in procs], "\n".join(log)


@functools.lru_cache(maxsize=1)
@tracing.traced("vcbm25.build.kernels")
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    tag = _tag(sources)
    path = os.path.join(_BUILD, f"libbm25_kernels_{tag}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        # Build in a private directory, then rename: concurrent builders
        # never load a half-written library.
        work = tempfile.mkdtemp(dir=_BUILD)
        try:
            objects, log = _compile(sources, work)
            tmp = os.path.join(work, "lib.so")
            proc = subprocess.run(
                [nvcc_path(), "-shared", "-o", tmp, *objects],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            with open(path + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return lib


def build_log() -> str:
    """nvcc's output for the loaded library (ptxas: registers, shared
    memory and spills of every kernel); empty if it was not kept."""
    lib = library()
    try:
        with open(lib._name + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""
