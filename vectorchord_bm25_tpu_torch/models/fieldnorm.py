"""Fieldnorm (document-length) quantization.

Documents lengths are quantized to a single byte ("fieldnorm") through a
256-entry exponential table, exactly as the reference engine does
(reference: crates/bm25/src/bm25.rs:15-283).  The table is identity for
lengths 0..=39 and then grows geometrically in groups of eight entries:
for byte b >= 40 with g = (b - 40) // 8 and i = (b - 40) % 8,

    length(b) = 24 + 2**(g + 4) + i * 2**(g + 1)

which reproduces the reference's FIELDNORM_TO_LENGTH table bit-for-bit
(verified against all 256 entries).  `length_to_fieldnorm` is the floor
inverse (reference: crates/bm25/src/bm25.rs:278-283).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "FIELDNORM_TO_LENGTH",
    "fieldnorm_to_length",
    "length_to_fieldnorm",
]


def _build_table() -> np.ndarray:
    table = np.empty(256, dtype=np.int64)
    table[:40] = np.arange(40)
    for b in range(40, 256):
        g, i = divmod(b - 40, 8)
        table[b] = 24 + (1 << (g + 4)) + i * (1 << (g + 1))
    return table


#: FIELDNORM_TO_LENGTH[b] = decoded document length for fieldnorm byte b.
FIELDNORM_TO_LENGTH: np.ndarray = _build_table()
FIELDNORM_TO_LENGTH.setflags(write=False)


def fieldnorm_to_length(fieldnorm):
    """Decode fieldnorm byte(s) to document length(s).

    Accepts scalars or arrays; mirrors crates/bm25/src/bm25.rs:274-276.
    """
    return FIELDNORM_TO_LENGTH[np.asarray(fieldnorm, dtype=np.int64)]


def length_to_fieldnorm(length):
    """Quantize document length(s) to fieldnorm byte(s) (floor).

    Mirrors crates/bm25/src/bm25.rs:278-283: the largest byte whose decoded
    length does not exceed `length`.
    """
    length = np.asarray(length, dtype=np.int64)
    # searchsorted(side="right") - 1 == binary_search floor
    idx = np.searchsorted(FIELDNORM_TO_LENGTH, length, side="right") - 1
    result = idx.astype(np.uint8)
    if result.ndim == 0:
        return np.uint8(result)
    return result
