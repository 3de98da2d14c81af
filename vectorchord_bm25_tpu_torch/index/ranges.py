"""Range index: doc-aligned block-max metadata for the pruned engine.

The reference's Block-Max WAND walks per-term 128-posting blocks with
serial pivot selection and data-dependent seeks (search.rs:151-280) —
pointer-chasing that cannot map onto a vector machine.  The TPU-native
equivalent aligns the pruning granule to the *document axis* instead:

- the doc space is partitioned into fixed ranges of RANGE docs;
- for each (term, range) with postings, we store the posting span into
  the term's flat posting array and the exact maximum BM25 score any doc
  in that span can receive from this term (the SummaryTuple analog,
  tuples.rs:900-971, with doc-aligned instead of count-aligned blocks);
- a query's per-range upper bound is then one scatter-add over its
  terms' (range, max-score) lists — a dense [R] vector the engine can
  sort and walk in fixed-size chunks with masked gathers.

Σ_t max_score(t, range) bounds every doc's score in the range, so
processing ranges in upper-bound order with a running top-k threshold
skips exactly the work Block-Max WAND skips — vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from ..models.scoring import ScoreTables
from .sealed import SealedSegment

RANGE = 128  # docs per range (tunable; smaller = tighter bounds, more meta)

__all__ = ["RANGE", "RangeIndex", "build_range_index", "ranges_from_reference"]


@dataclass
class RangeIndex:
    """Doc-aligned block-max metadata over one sealed segment."""

    range_size: int
    n_ranges: int

    # Flat postings, (term, doc) sorted; pad tail of `range_size` sentinels.
    post_docid: np.ndarray  # [total + range_size] int32 (pad = n_docs)
    post_tf: np.ndarray  # [total + range_size] int32 (pad = 0)

    # Compact device forms (the byte-packing analog, compression.rs:52-62,
    # fused with impact-eager scoring): doc ids stored range-relative in
    # one byte (requires range_size <= 256) and the posting's full
    # precomputed score (BM25S-style) — query scoring is gather + sum
    # with no table lookups or divisions, at 5 bytes/posting in HBM.
    post_local: np.ndarray  # [total + range_size] uint8 (doc - range*RS)
    post_impact: np.ndarray  # [total + range_size] float32 (pad = 0)

    # Per-(term, range) groups, term-major then range-ascending.
    tr_range: np.ndarray  # [M] int32 range id
    tr_start: np.ndarray  # [M] int32 offset into post_* arrays
    tr_len: np.ndarray  # [M] int32 (1..=range_size)
    tr_ub: np.ndarray  # [M] float32 exact max score within the span

    # CSR: token id -> slice of tr_* arrays.
    token_tr_start: np.ndarray  # [V+1] int64

    def memory_bytes(self, compact: bool = True) -> int:
        """Device-resident bytes for the pruned engine (impact-eager
        postings by default; the u32 arrays are host-side build forms)."""
        postings = (
            self.post_local.nbytes + self.post_impact.nbytes
            if compact
            else self.post_docid.nbytes + self.post_tf.nbytes
        )
        return (
            postings
            + self.tr_range.nbytes
            + self.tr_start.nbytes
            + self.tr_len.nbytes
            + self.tr_ub.nbytes
            + self.token_tr_start.nbytes
        )


def default_range_size(n_docs: int) -> int:
    """Scale-aware default: larger ranges at larger corpus sizes keep the
    per-range metadata and the round count bounded (u8 locals cap at 256)."""
    return 128 if n_docs < 500_000 else 256


def build_range_index(
    seg: SealedSegment,
    range_size: "int | None" = None,
    global_stats: "tuple | None" = None,
) -> RangeIndex:
    """Derive the range index from a sealed segment's postings.

    global_stats: optional (n_docs_total, sum_dl_total, token_s0 [V]) —
    used by doc-sharded indexes so per-posting impacts bake in the
    *global* idf/avgdl (scoring must match a single-node build; the
    reference's parallel build likewise computes statistics globally
    before flush).
    """
    if range_size is None:
        range_size = default_range_size(seg.n_docs)
    if not (1 <= range_size <= 256):
        raise ValueError("range_size must be in [1, 256] (u8 local ids)")
    n = seg.n_docs
    n_ranges = max(1, -(-max(n, 1) // range_size))
    tok, doc, tfv = seg.postings()
    total = tok.size

    if total == 0:
        return RangeIndex(
            range_size=range_size,
            n_ranges=n_ranges,
            post_docid=np.full(range_size, n, dtype=np.int32),
            post_tf=np.zeros(range_size, dtype=np.int32),
            post_local=np.zeros(range_size, dtype=np.uint8),
            post_impact=np.zeros(range_size, dtype=np.float32),
            tr_range=np.zeros(0, dtype=np.int32),
            tr_start=np.zeros(0, dtype=np.int32),
            tr_len=np.zeros(0, dtype=np.int32),
            tr_ub=np.zeros(0, dtype=np.float32),
            token_tr_start=np.zeros(seg.n_tokens + 1, dtype=np.int64),
        )

    rng_of = doc.astype(np.int64) // range_size

    # Group boundaries where (token, range) changes; postings are already
    # (token, doc) sorted so groups are contiguous.
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = (tok[1:] != tok[:-1]) | (rng_of[1:] != rng_of[:-1])
    starts = np.flatnonzero(boundary)
    m = starts.size
    lens = np.diff(np.append(starts, total))

    # Exact max score per group (the block-max): full idf*tf score.
    if global_stats is not None:
        n_total, sum_dl_total, s0 = global_stats
        tables = ScoreTables.create(
            seg.options.k1, seg.options.b, n_total, sum_dl_total
        )
        s0 = np.asarray(s0, dtype=np.float64)
    else:
        tables = seg.score_tables()
        s0 = seg.token_s0()
    fn = seg.doc_fieldnorm[doc].astype(np.int64)
    t64 = tfv.astype(np.float64)
    scores = (t64 * s0[tok]) / (t64 + tables.s1_table[fn])
    ub = np.maximum.reduceat(scores, starts)
    # The device engine scores in float32; pad the bound by a few ulps so
    # float rounding can never push a real score above its range's bound
    # (pruning must stay conservative).
    ub = np.nextafter(
        (ub * (1.0 + 1e-6)).astype(np.float32), np.float32(np.inf)
    )

    # CSR per token over groups.
    group_tok = tok[starts].astype(np.int64)
    token_tr_start = np.zeros(seg.n_tokens + 1, dtype=np.int64)
    np.add.at(token_tr_start, group_tok + 1, 1)
    np.cumsum(token_tr_start, out=token_tr_start)

    pad_doc = np.full(range_size, n, dtype=np.int32)
    pad_tf = np.zeros(range_size, dtype=np.int32)
    local = (doc.astype(np.int64) - rng_of * range_size).astype(np.uint8)
    return RangeIndex(
        range_size=range_size,
        n_ranges=n_ranges,
        post_docid=np.concatenate([doc.astype(np.int32), pad_doc]),
        post_tf=np.concatenate([tfv.astype(np.int32), pad_tf]),
        post_local=np.concatenate(
            [local, np.zeros(range_size, dtype=np.uint8)]
        ),
        post_impact=np.concatenate(
            [
                scores.astype(np.float32),
                np.zeros(range_size, dtype=np.float32),
            ]
        ),
        tr_range=rng_of[starts].astype(np.int32),
        tr_start=starts.astype(np.int32),
        tr_len=lens.astype(np.int32),
        tr_ub=ub.astype(np.float32),
        token_tr_start=token_tr_start,
    )


def ranges_from_reference(ri) -> RangeIndex:
    """The port's ``RangeIndex`` holding a copy of another range index's
    fields (one built by the JAX package): state crosses by value.  A port
    range index is returned as it is."""
    if isinstance(ri, RangeIndex):
        return ri
    return RangeIndex(
        **{
            f.name: (
                int(getattr(ri, f.name))
                if f.name in ("range_size", "n_ranges")
                else np.array(getattr(ri, f.name))
            )
            for f in fields(RangeIndex)
        }
    )
