"""Total-order packing of float64 scores into int64 keys.

The reference's `Score` type (crates/score/src/lib.rs:32-66) packs an f64
into an i64 whose integer ordering matches IEEE-754 total order (the
sign-flip trick), so score heaps avoid float-compare pitfalls (NaN, ±0).
We reproduce the same bijection for use as sort keys on host and device.

    packed = bits                      if bits >= 0   (positive floats)
    packed = bits ^ 0x7fff_ffff_ffff_ffff  otherwise  (negative floats)

(interpreting the f64 bit pattern as i64).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_score", "unpack_score"]

_MASK = np.int64(0x7FFFFFFFFFFFFFFF)


def pack_score(x) -> np.ndarray:
    """f64 -> i64 preserving total order (reference score/src/lib.rs:46-53)."""
    bits = np.asarray(x, dtype=np.float64).view(np.int64)
    return np.where(bits >= 0, bits, bits ^ _MASK)


def unpack_score(packed) -> np.ndarray:
    """i64 -> f64 inverse of :func:`pack_score` (lib.rs:55-60)."""
    packed = np.asarray(packed, dtype=np.int64)
    bits = np.where(packed >= 0, packed, packed ^ _MASK)
    return bits.view(np.float64)
