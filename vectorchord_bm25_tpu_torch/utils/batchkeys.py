"""Shared batched token-lookup expansion.

Every engine front-end needs the same host-side step: concatenate the
batch's query keys, run ONE vectorized token lookup, and get back the
matched ids with their query indices (plus per-query positions for
scatter into padded [Q, W] layouts).  Previously this ~10-line idiom
was copy-pasted per engine; any change (key width, dedup policy) must
happen here once.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

from ..text.intern import WIDTH

__all__ = ["batch_lookup", "group_positions", "select_rows"]

_KEY_DT = f"S{WIDTH}"


def batch_lookup(
    lookup: Callable[[np.ndarray], np.ndarray],
    queries: Sequence,
) -> Tuple[np.ndarray, np.ndarray]:
    """One vectorized lookup over the concatenated batch keys.

    Returns (ids, qidx): matched token ids (>= 0 only) and the query
    index of each, both in query order (qidx ascending, term order
    preserved within a query).
    """
    qn = len(queries)
    key_arrays = [np.asarray(q.keys, dtype=_KEY_DT) for q in queries]
    kcounts = np.fromiter(
        (a.size for a in key_arrays), dtype=np.int64, count=qn
    )
    if kcounts.sum() == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    ids = np.asarray(
        lookup(np.concatenate(key_arrays)), dtype=np.int64
    )
    qidx = np.repeat(np.arange(qn, dtype=np.int64), kcounts)
    keep = ids >= 0
    return ids[keep], qidx[keep]


def select_rows(
    ids: np.ndarray, qidx: np.ndarray, qn: int, rows: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The looked-up batch ``(ids, qidx)`` of ``qn`` queries cut to the
    queries ``rows`` (ascending): their ids, in order, and their query
    indices renumbered ``0..rows.size`` — what ``batch_lookup`` gives for
    that sub-batch."""
    if rows.size == qn:
        return ids, qidx
    remap = np.full(qn, -1, dtype=np.int64)
    remap[rows] = np.arange(rows.size)
    sub = remap[qidx]
    sel = sub >= 0
    return ids[sel], sub[sel]


def group_positions(sizes: np.ndarray) -> np.ndarray:
    """Within-group positions for items laid out group-by-group:
    [0..sizes[0]), [0..sizes[1]), ... — the arange-minus-repeat(cumsum)
    idiom used to scatter flat per-group arrays into padded [G, W]
    matrices."""
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes
    )
