"""ctypes loader for the native C++ library (libvcbm25.so).

The native library provides the host-side hot paths that the reference
implements in Rust: blake3 keyed interning (crates/bm25/src/vector.rs),
the block compression codecs (crates/simd), and the external-sort merge
(crates/bm25/src/io.rs).  Everything has a pure-Python/numpy fallback, so
the framework works without a compiler; the loader returns None when the
library is absent and callers fall back.

The library is built at first use with the host ``g++`` from ``src/`` and
the Makefile's flags (``CXXFLAGS``), into ``vectorchord_bm25_tpu_torch/_build/``
under a name hashed from the sources, the flags and the machine, so a
second process reuses it and an edited source rebuilds.  Nothing is built
or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import warnings

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
# The Makefile's CXXFLAGS and LDFLAGS (tests/test_torch_native.py holds the
# two equal).
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared",)

# Merges done by the native merger (``merge_mappings`` calls that returned
# True); a caller zeroes it, builds, and reads it.
MERGES = 0
# The compiler's output when the last build failed, else "".
BUILD_ERROR = ""


def _sources():
    return sorted(glob.glob(os.path.join(_HERE, "src", "*.cpp")))


def _tag(sources) -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(platform.machine().encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    """The built library's path, compiling it first if no process has;
    None where no ``g++`` is found or the build fails (``BUILD_ERROR``
    then holds why)."""
    global BUILD_ERROR
    cxx = shutil.which("g++")
    if cxx is None:
        BUILD_ERROR = "no g++ on PATH"
        return None
    sources = _sources()
    path = os.path.join(_BUILD, f"libvcbm25_{_tag(sources)}.so")
    if os.path.exists(path):
        return path
    try:
        os.makedirs(_BUILD, exist_ok=True)
        # Build in a private directory, then rename: processes building at
        # once (pytest workers, spawned build workers) never load a
        # half-written library.
        work = tempfile.mkdtemp(dir=_BUILD)
    except OSError as e:
        BUILD_ERROR = f"cannot write {_BUILD}: {e}"
        return None
    try:
        tmp = os.path.join(work, "libvcbm25.so")
        proc = subprocess.run(
            [cxx, *CXXFLAGS, *LDFLAGS, "-o", tmp, *sources],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            BUILD_ERROR = f"g++ exit {proc.returncode}:\n{proc.stdout}{proc.stderr}"
            warnings.warn(f"native library not built, numpy fallbacks used: {BUILD_ERROR}")
            return None
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


@functools.lru_cache(maxsize=1)
def _load():
    path = library_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _declare(lib)
    return lib


def _declare(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    u32p = c.POINTER(c.c_uint32)
    i64p = c.POINTER(c.c_int64)

    lib.vcbm25_blake3_keyed_hash16.argtypes = [
        c.c_char_p, c.c_char_p, c.c_size_t, c.c_char_p,
    ]
    lib.vcbm25_blake3_keyed_hash16.restype = None
    lib.vcbm25_intern_batch.argtypes = [c.c_char_p, u8p, i64p, c.c_int64, u8p]
    lib.vcbm25_intern_batch.restype = None

    lib.vcbm25_compress_blocks_ordered.argtypes = [
        u32p, u32p, c.c_int64, u8p, u32p, i64p,
    ]
    lib.vcbm25_compress_blocks_ordered.restype = None
    lib.vcbm25_decompress_blocks_ordered.argtypes = [
        u32p, u32p, i64p, c.c_int64, u8p, u32p,
    ]
    lib.vcbm25_decompress_blocks_ordered.restype = None
    lib.vcbm25_compress_blocks_unordered.argtypes = [
        u32p, c.c_int64, u8p, u32p, i64p,
    ]
    lib.vcbm25_compress_blocks_unordered.restype = None
    lib.vcbm25_decompress_blocks_unordered.argtypes = [
        u32p, i64p, c.c_int64, u8p, u32p,
    ]
    lib.vcbm25_decompress_blocks_unordered.restype = None

    i32p = c.POINTER(c.c_int32)
    lib.vcbm25_bytepack_blocks_ordered.argtypes = [
        u32p, u32p, i32p, c.c_int64, u8p, u32p, i64p,
    ]
    lib.vcbm25_bytepack_blocks_ordered.restype = None
    lib.vcbm25_byteunpack_blocks_ordered.argtypes = [
        u32p, u32p, i64p, i32p, c.c_int64, u8p, u32p,
    ]
    lib.vcbm25_byteunpack_blocks_ordered.restype = None
    lib.vcbm25_bytepack_blocks_unordered.argtypes = [
        u32p, i32p, c.c_int64, u8p, u32p, i64p,
    ]
    lib.vcbm25_bytepack_blocks_unordered.restype = None
    lib.vcbm25_byteunpack_blocks_unordered.argtypes = [
        u32p, i64p, i32p, c.c_int64, u8p, u32p,
    ]
    lib.vcbm25_byteunpack_blocks_unordered.restype = None

    lib.vcbm25_sort_mappings_file.argtypes = [c.c_char_p]
    lib.vcbm25_sort_mappings_file.restype = c.c_int
    lib.vcbm25_merge_mappings.argtypes = [
        c.POINTER(c.c_char_p), i64p, c.c_int, c.c_char_p,
    ]
    lib.vcbm25_merge_mappings.restype = c.c_int


def library():
    """The raw CDLL handle (or None)."""
    return _load()


def available() -> bool:
    return _load() is not None


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def blake3_keyed_hash16():
    """Returns fn(seed32: bytes, data: bytes) -> bytes16, or None."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.vcbm25_blake3_keyed_hash16

    def call(seed: bytes, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(16)
        fn(seed, data, len(data), out)
        return out.raw

    return call


def intern_batch(seed: bytes, tokens) -> "np.ndarray | None":
    """Batch-intern tokens (list of bytes) -> [n] |S16 array, or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(tokens)
    blobs = b"".join(tokens)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(t) for t in tokens], out=offsets[1:])
    data = np.frombuffer(blobs, dtype=np.uint8) if blobs else np.zeros(0, np.uint8)
    out = np.zeros(n * 16, dtype=np.uint8)
    lib.vcbm25_intern_batch(
        seed,
        _as_ptr(np.ascontiguousarray(data), ctypes.c_uint8),
        _as_ptr(offsets, ctypes.c_int64),
        n,
        _as_ptr(out, ctypes.c_uint8),
    )
    return out.view(dtype="S16")


# ---------------------------------------------------------------------------
def compress_blocks(vals: np.ndarray, bases=None):
    """Compress [B, 128] uint32 blocks; delta-coded when `bases` given.

    Returns (packed bytes, bitwidths [B] u32, offsets [B+1] i64) or None.
    """
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    b = vals.shape[0]
    out = np.zeros(vals.size * 4 + 8, dtype=np.uint8)
    bitwidths = np.zeros(b, dtype=np.uint32)
    offsets = np.zeros(b + 1, dtype=np.int64)
    if bases is not None:
        bases = np.ascontiguousarray(bases, dtype=np.uint32)
        lib.vcbm25_compress_blocks_ordered(
            _as_ptr(bases, ctypes.c_uint32),
            _as_ptr(vals, ctypes.c_uint32),
            b,
            _as_ptr(out, ctypes.c_uint8),
            _as_ptr(bitwidths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
        )
    else:
        lib.vcbm25_compress_blocks_unordered(
            _as_ptr(vals, ctypes.c_uint32),
            b,
            _as_ptr(out, ctypes.c_uint8),
            _as_ptr(bitwidths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
        )
    return out[: offsets[-1]].copy(), bitwidths, offsets


def decompress_blocks(packed, bitwidths, offsets, bases=None):
    """Inverse of compress_blocks -> [B, 128] uint32, or None."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    bitwidths = np.ascontiguousarray(bitwidths, dtype=np.uint32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    b = bitwidths.size
    vals = np.zeros((b, 128), dtype=np.uint32)
    if bases is not None:
        bases = np.ascontiguousarray(bases, dtype=np.uint32)
        lib.vcbm25_decompress_blocks_ordered(
            _as_ptr(bases, ctypes.c_uint32),
            _as_ptr(bitwidths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
            b,
            _as_ptr(packed, ctypes.c_uint8),
            _as_ptr(vals, ctypes.c_uint32),
        )
    else:
        lib.vcbm25_decompress_blocks_unordered(
            _as_ptr(bitwidths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
            b,
            _as_ptr(packed, ctypes.c_uint8),
            _as_ptr(vals, ctypes.c_uint32),
        )
    return vals


# ---------------------------------------------------------------------------
def bytepack_blocks(vals: np.ndarray, ns: np.ndarray, bases=None):
    """Byte-pack the first ns[i] entries of each [B, 128] row (the
    reference's partial-block codec, compression.rs:52-62); delta-coded
    when `bases` given.  Returns (bytes, widths [B] u32, offsets [B+1]) or
    None without the native library."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    b = vals.shape[0]
    out = np.zeros(vals.size * 4 + 8, dtype=np.uint8)
    widths = np.zeros(b, dtype=np.uint32)
    offsets = np.zeros(b + 1, dtype=np.int64)
    if bases is not None:
        bases = np.ascontiguousarray(bases, dtype=np.uint32)
        lib.vcbm25_bytepack_blocks_ordered(
            _as_ptr(bases, ctypes.c_uint32),
            _as_ptr(vals, ctypes.c_uint32),
            _as_ptr(ns, ctypes.c_int32),
            b,
            _as_ptr(out, ctypes.c_uint8),
            _as_ptr(widths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
        )
    else:
        lib.vcbm25_bytepack_blocks_unordered(
            _as_ptr(vals, ctypes.c_uint32),
            _as_ptr(ns, ctypes.c_int32),
            b,
            _as_ptr(out, ctypes.c_uint8),
            _as_ptr(widths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
        )
    return out[: offsets[-1]].copy(), widths, offsets


def byteunpack_blocks(packed, widths, offsets, ns, bases=None, fill=0):
    """Inverse of bytepack_blocks -> [B, 128] uint32 (slots >= ns[i] hold
    `fill`), or None."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    widths = np.ascontiguousarray(widths, dtype=np.uint32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    b = widths.size
    vals = np.full((b, 128), fill, dtype=np.uint32)
    if bases is not None:
        bases = np.ascontiguousarray(bases, dtype=np.uint32)
        lib.vcbm25_byteunpack_blocks_ordered(
            _as_ptr(bases, ctypes.c_uint32),
            _as_ptr(widths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
            _as_ptr(ns, ctypes.c_int32),
            b,
            _as_ptr(packed, ctypes.c_uint8),
            _as_ptr(vals, ctypes.c_uint32),
        )
    else:
        lib.vcbm25_byteunpack_blocks_unordered(
            _as_ptr(widths, ctypes.c_uint32),
            _as_ptr(offsets, ctypes.c_int64),
            _as_ptr(ns, ctypes.c_int32),
            b,
            _as_ptr(packed, ctypes.c_uint8),
            _as_ptr(vals, ctypes.c_uint32),
        )
    return vals


# ---------------------------------------------------------------------------
def sort_mappings_file(path: str) -> bool:
    lib = _load()
    if lib is None:
        return False
    return lib.vcbm25_sort_mappings_file(path.encode()) == 0


def merge_mappings(run_paths, doc_offsets, out_path: str) -> bool:
    lib = _load()
    if lib is None:
        return False
    n = len(run_paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in run_paths])
    offs = np.ascontiguousarray(doc_offsets, dtype=np.int64)
    ok = (
        lib.vcbm25_merge_mappings(
            arr, _as_ptr(offs, ctypes.c_int64), n, out_path.encode()
        )
        == 0
    )
    if ok:
        global MERGES
        MERGES += 1
    return ok
