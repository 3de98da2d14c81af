"""Numpy bit-packing codec for compressed on-disk segments (the port's
copy of the reference's ``ops/bitpack.py``, logic unchanged).

Value i of width B lives at bit i*B of the little-endian packed stream, so
each value straddles at most two 32-bit words.  Used by index/storage.py
for the full 128-blocks of ``sealed.npz``; the bytes are the reference's.

Device-side serving from bit-packed device memory lives in
search/stream.py (the StreamEngine's kernels decompress windows in
registers, fused with scoring).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pack_u32_np",
    "unpack_u32_np",
]

BLOCK = 128


def pack_u32_np(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint32 values at `bits` width into a little-endian uint32
    word stream."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.size
    if bits == 0:
        return np.zeros(0, dtype=np.uint32)
    total_bits = n * bits
    n_words = (total_bits + 31) // 32
    out = np.zeros(n_words + 1, dtype=np.uint64)  # +1 spill word
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    word = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    lo = (values << off) & np.uint64(0xFFFFFFFF)
    hi = values >> (np.uint64(32) - off)
    hi = np.where(off == 0, np.uint64(0), hi)
    np.bitwise_or.at(out, word, lo)
    np.bitwise_or.at(out, word + 1, hi)
    return out[:n_words].astype(np.uint32)


def unpack_u32_np(packed: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of pack_u32_np."""
    if bits == 0:
        return np.zeros(count, dtype=np.uint32)
    words = np.zeros(packed.size + 1, dtype=np.uint64)
    words[: packed.size] = np.asarray(packed, dtype=np.uint64)
    bitpos = np.arange(count, dtype=np.uint64) * np.uint64(bits)
    word = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    lo = words[word] >> off
    hi = words[word + 1] << (np.uint64(32) - off)
    hi = np.where(off == 0, np.uint64(0), hi)
    mask = np.uint64((1 << bits) - 1)
    return ((lo | hi) & mask).astype(np.uint32)
