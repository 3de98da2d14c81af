"""Shared shape-bucketing helper (bounds the jit cache size)."""

from __future__ import annotations

__all__ = ["bucket_pow2"]


def bucket_pow2(x: int, minimum: int = 8) -> int:
    """Round up to a power of two."""
    n = max(x, minimum)
    return 1 << (n - 1).bit_length()
