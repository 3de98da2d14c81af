"""Host oracles (counterpart of ``search/exact.py:685-739``).

``oracle_scores`` and ``oracle_topk`` are the reference's float oracles,
copied unchanged: dense per-doc BM25 scores on the host and their top-k
under the pinned (score desc, doc asc) rule.  The port's tests and
``chip_smoke.py`` hold every engine against them.  ``ExactEngine`` (the
reference's E1-E3) is still to port (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..index.sealed import SealedSegment
from ..text.intern import Query
from ..utils.scorepack import pack_score

__all__ = ["oracle_scores", "oracle_topk"]


def oracle_scores(
    segment: SealedSegment,
    query: Query,
    deleted: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Dense per-doc BM25 scores, computed on host (float oracle).

    float64 gives the reference's host precision; float32 approximates the
    device engine (which gathers build-time float32 impacts) to ~1 ulp.
    """
    tables = segment.score_tables()
    ids = segment.lookup_tokens(query.keys)
    ids = ids[ids >= 0]
    acc = np.zeros(segment.n_docs, dtype=dtype)
    s0_all = segment.token_s0()
    for tid in ids:
        lo = int(segment.token_block_start[tid])
        hi = int(segment.token_block_start[tid + 1])
        docs = segment.block_docids[lo:hi].reshape(-1)
        tfs = segment.block_tfs[lo:hi].reshape(-1)
        mask = docs < segment.n_docs
        docs, tfs = docs[mask], tfs[mask]
        fn = segment.doc_fieldnorm[docs].astype(np.int64)
        s0 = dtype(s0_all[tid])
        t = tfs.astype(dtype)
        s1 = tables.s1_table[fn].astype(dtype)
        acc[docs] += (t * s0) / (t + s1)
    if deleted is not None:
        acc = np.where(deleted[: segment.n_docs], dtype(0), acc)
    return acc


def oracle_topk(
    segment: SealedSegment,
    query: Query,
    k: int,
    deleted: Optional[np.ndarray] = None,
    filter_mask: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host top-k oracle with the pinned tie rule (score desc, doc asc)."""
    scores = oracle_scores(segment, query, deleted, dtype)
    if filter_mask is not None:
        scores = np.where(np.asarray(filter_mask, dtype=bool), scores, 0)
    keep = scores > 0
    docs = np.flatnonzero(keep)
    # Sort keys are the reference's total-order score packing (the Score
    # heap key, crates/score/src/lib.rs:32-66): pack(-s) ascends as s
    # descends, with none of float-compare's NaN/-0 pitfalls.
    order = np.lexsort((docs, pack_score(-scores[docs].astype(np.float64))))
    top = docs[order[:k]]
    return scores[top], top
