"""Sealed segment: the immutable structure-of-arrays inverted index.

This is the TPU-native analog of the reference's sealed segment, which
stores five page-chain "tapes" plus two address trees
(crates/bm25/src/tuples.rs, flush.rs).  Here the same information lives in
dense arrays resident in HBM:

- token table        — TokenTuple analog   (tuples.rs:833-898)
- block metadata     — SummaryTuple analog (tuples.rs:900-971)
- padded block data  — BlockTuple analog   (tuples.rs:973-1069), stored
  unpacked [B, 128] for VPU-friendly access (the bit-packed HBM serving
  form is index/stream.py + search/stream.py — the StreamEngine)
- doc table          — DocumentTuple + doc address tree analog
  (tuples.rs:756-831, 602-754): dense doc ids make the radix tree plain
  array indexing
- globals            — MetaTuple/JumpTuple analog (N, Σdl, k1, b, seed)

Postings are cut into blocks of 128 like the reference (flush.rs:68-136);
per-block and per-token max-impact (fieldnorm, tf) pairs are computed with
the same first-maximum semantics as the reference's `Wand` tracker
(bm25.rs:297-332).

The build is a vectorized sort/segment pipeline (the flush analog,
SURVEY.md §7): sort (key, doc, tf) triples, run-length the keys into the
token table, reshape per-token runs into padded 128-blocks, and
segment-reduce the block metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import numpy as np

from ..models.fieldnorm import length_to_fieldnorm
from ..models.scoring import ScoreTables, idf, tf as tf_score
from ..text.intern import WIDTH, Document
from ..utils import tracing
from ..utils.options import IndexOptions

BLOCK = 128  # postings per block (reference flush.rs:68-136)

__all__ = [
    "BLOCK",
    "SealedSegment",
    "build_sealed_segment",
    "build_sealed_segment_from_postings",
    "segment_from_reference",
]


@dataclass
class SealedSegment:
    """Immutable inverted index over dense doc slots [0, n_docs)."""

    options: IndexOptions
    n_docs: int
    sum_dl: int

    # Doc table.
    doc_fieldnorm: np.ndarray  # [N] uint8
    doc_payload: np.ndarray  # [N] int64 (opaque row ids; ctid analog)

    # Token table (sorted by key; V entries).
    token_keys: np.ndarray  # [V] |S16, strictly increasing
    token_df: np.ndarray  # [V] int32
    token_wand_fn: np.ndarray  # [V] uint8
    token_wand_tf: np.ndarray  # [V] int32
    token_block_start: np.ndarray  # [V+1] int32 CSR offsets into blocks

    # Block metadata ([B] entries).
    block_min_doc: np.ndarray  # [B] int32
    block_max_doc: np.ndarray  # [B] int32
    block_n: np.ndarray  # [B] int32 (1..=128)
    block_wand_fn: np.ndarray  # [B] uint8
    block_wand_tf: np.ndarray  # [B] int32

    # Padded block data ([B, 128]); doc pad sentinel = n_docs, tf pad = 0.
    block_docids: np.ndarray  # [B, 128] int32
    block_tfs: np.ndarray  # [B, 128] int32

    @property
    def n_tokens(self) -> int:
        return int(self.token_keys.size)

    @property
    def n_blocks(self) -> int:
        return int(self.block_n.size)

    @property
    def avgdl(self) -> float:
        return float(self.sum_dl) / float(self.n_docs) if self.n_docs else 1.0

    def score_tables(self) -> ScoreTables:
        return ScoreTables.create(
            self.options.k1, self.options.b, self.n_docs, self.sum_dl
        )

    def token_s0(self) -> np.ndarray:
        """Per-token s0 = idf * (k1 + 1) (float64 [V])."""
        return idf(self.n_docs, self.token_df) * (self.options.k1 + 1.0)

    def block_impacts(
        self, dtype=np.float32, global_stats=None
    ) -> np.ndarray:
        """Precomputed per-posting scores [B, 128] (eager/impact scoring).

        BM25 ignores query-side term frequency, so a posting's full score
        contribution idf(df) * tf_sat(tf, fieldnorm) is known at build
        time (the BM25S observation).  Query scoring reduces to gather +
        segment-sum; computed in float64 and rounded once to `dtype`.
        Padding slots score 0.

        global_stats: optional (n_docs_total, sum_dl_total, token_s0 [V])
        so doc-sharded segments bake in global idf/avgdl.
        """
        if global_stats is not None:
            n_total, sum_dl_total, s0 = global_stats
            tables = ScoreTables.create(
                self.options.k1, self.options.b, n_total, sum_dl_total
            )
            s0 = np.asarray(s0, dtype=np.float64)
        else:
            tables = self.score_tables()
            s0 = self.token_s0()
        block_token = np.repeat(
            np.arange(self.n_tokens, dtype=np.int64),
            np.diff(self.token_block_start),
        )
        fn = np.where(
            self.block_docids < self.n_docs,
            self.doc_fieldnorm[np.minimum(self.block_docids, self.n_docs - 1)],
            0,
        ).astype(np.int64)
        t = self.block_tfs.astype(np.float64)
        s1 = tables.s1_table[fn]
        with np.errstate(invalid="ignore", divide="ignore"):
            imp = np.where(
                t > 0, (t * s0[block_token][:, None]) / (t + s1), 0.0
            )
        return imp.astype(dtype)

    def lookup_tokens(self, keys: np.ndarray) -> np.ndarray:
        """Map 16-byte keys -> token ids; missing keys -> -1.

        The address_tokens B+-tree analog (crates/bm25/src/address_tokens.rs):
        binary search over the sorted key array.
        """
        keys = np.asarray(keys, dtype=f"S{WIDTH}")
        idxs = np.searchsorted(self.token_keys, keys)
        idxs = np.minimum(idxs, max(self.n_tokens - 1, 0))
        if self.n_tokens == 0:
            return np.full(keys.shape, -1, dtype=np.int64)
        found = self.token_keys[idxs] == keys
        return np.where(found, idxs, -1)

    def token_blocks(self, token_id: int) -> np.ndarray:
        """Block ids of one token (CSR slice)."""
        lo = int(self.token_block_start[token_id])
        hi = int(self.token_block_start[token_id + 1])
        return np.arange(lo, hi, dtype=np.int32)

    def memory_bytes(self) -> int:
        """Total bytes of the array-resident index (for memory-parity checks)."""
        total = 0
        for name in (
            "doc_fieldnorm",
            "doc_payload",
            "token_keys",
            "token_df",
            "token_wand_fn",
            "token_wand_tf",
            "token_block_start",
            "block_min_doc",
            "block_max_doc",
            "block_n",
            "block_wand_fn",
            "block_wand_tf",
            "block_docids",
            "block_tfs",
        ):
            total += getattr(self, name).nbytes
        return total

    def flat_impact_postings(
        self, global_stats=None, dtype=np.float32
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flat (token, doc)-ordered posting stream with precomputed
        impacts: (docids int32 [P], impacts [P], token_flat_start [V+1]).

        The zero-padding dense form: the CSR maps each token to its
        contiguous posting span (Σ df offsets), so device storage is
        exactly 1 posting per lane — the equal-index-memory layout for
        the dense engine (the reference likewise stores no padding,
        compression.rs:52-62).
        """
        tok, doc, tfv = self.postings()
        if global_stats is not None:
            n_total, sum_dl_total, s0 = global_stats
            tables = ScoreTables.create(
                self.options.k1, self.options.b, n_total, sum_dl_total
            )
            s0 = np.asarray(s0, dtype=np.float64)
        else:
            tables = self.score_tables()
            s0 = self.token_s0()
        fn = self.doc_fieldnorm[doc].astype(np.int64)
        t = tfv.astype(np.float64)
        imp = (t * s0[tok]) / (t + tables.s1_table[fn])
        csr = np.zeros(self.n_tokens + 1, dtype=np.int64)
        csr[1:] = np.cumsum(self.token_df.astype(np.int64))
        return doc.astype(np.int32), imp.astype(dtype), csr

    def postings(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Invert back to sorted (token_id, doc_id, tf) triples.

        Used by maintain/merge (the reference re-derives postings by
        decompressing every block, maintain.rs:104-161); our blocks are
        already decompressed arrays so this is a masked flatten.
        """
        valid = self.block_docids < self.n_docs
        block_token = np.repeat(
            np.arange(self.n_tokens, dtype=np.int32),
            np.diff(self.token_block_start),
        )
        token_of = np.broadcast_to(block_token[:, None], self.block_docids.shape)
        return (
            token_of[valid].astype(np.int32),
            self.block_docids[valid].astype(np.int32),
            self.block_tfs[valid].astype(np.int32),
        )


def _empty_segment(options: IndexOptions) -> SealedSegment:
    return SealedSegment(
        options=options,
        n_docs=0,
        sum_dl=0,
        doc_fieldnorm=np.zeros(0, dtype=np.uint8),
        doc_payload=np.zeros(0, dtype=np.int64),
        token_keys=np.zeros(0, dtype=f"S{WIDTH}"),
        token_df=np.zeros(0, dtype=np.int32),
        token_wand_fn=np.zeros(0, dtype=np.uint8),
        token_wand_tf=np.zeros(0, dtype=np.int32),
        token_block_start=np.zeros(1, dtype=np.int32),
        block_min_doc=np.zeros(0, dtype=np.int32),
        block_max_doc=np.zeros(0, dtype=np.int32),
        block_n=np.zeros(0, dtype=np.int32),
        block_wand_fn=np.zeros(0, dtype=np.uint8),
        block_wand_tf=np.zeros(0, dtype=np.int32),
        block_docids=np.zeros((0, BLOCK), dtype=np.int32),
        block_tfs=np.zeros((0, BLOCK), dtype=np.int32),
    )


def build_sealed_segment(
    documents: Sequence[Document],
    payloads: Optional[Sequence[int]] = None,
    options: Optional[IndexOptions] = None,
    progress=None,
) -> SealedSegment:
    """Build a sealed segment from documents (the flush analog, flush.rs:40-190).

    documents: per-doc sorted-unique (key, tf) vectors; doc slot = position.
    payloads: opaque int64 row ids (default: the doc slot itself).
    progress: optional callable(phase: str, done: int, total: int) mirroring
        the reference's build progress reporting (am_build.rs:96-125).
    """
    options = options or IndexOptions()
    n = len(documents)
    if n == 0:
        return _empty_segment(options)

    counts = np.fromiter((len(d) for d in documents), dtype=np.int64, count=n)
    if counts.sum() == 0:
        all_keys = np.zeros(0, dtype=f"S{WIDTH}")
        all_tfs = np.zeros(0, dtype=np.int64)
    else:
        all_keys = np.concatenate([d.keys for d in documents]).astype(
            f"S{WIDTH}"
        )
        all_tfs = np.concatenate([d.values for d in documents]).astype(
            np.int64
        )
    all_docs = np.repeat(np.arange(n, dtype=np.int64), counts)
    return build_sealed_segment_from_postings(
        all_keys,
        all_docs,
        all_tfs,
        n,
        payloads=payloads,
        options=options,
        progress=progress,
        presorted=False,
        doc_grouped=True,
    )


@tracing.traced("vcbm25.build.sealed")
def build_sealed_segment_from_postings(
    keys: Optional[np.ndarray],  # [P] |S16 (None iff token_ids given)
    doc_ids: np.ndarray,  # [P] int64, in [0, n_docs)
    tfs: np.ndarray,  # [P] int64, nonzero
    n_docs: int,
    payloads: Optional[Sequence[int]] = None,
    options: Optional[IndexOptions] = None,
    progress=None,
    presorted: bool = False,
    doc_grouped: bool = False,
    token_ids: Optional[np.ndarray] = None,
    vocab_keys: Optional[np.ndarray] = None,
) -> SealedSegment:
    """Build directly from flat (key, doc, tf) postings — the fast path for
    bulk ingestion and the entry point for externally sorted/merged runs
    (the io.rs merge output feeds here).  (key, doc) pairs must be unique;
    presorted=True skips the sort when input is already (key, doc) ordered;
    doc_grouped=True skips the doc-order pre-pass when postings arrive
    grouped by doc (saves one stable sort).

    token_ids/vocab_keys: dense-id alternative to `keys` — postings carry
    int ids into the sorted `vocab_keys` table instead of 16-byte keys
    (what maintain's relabel produces; avoids a [P]-sized S16 copy).
    Requires presorted=True with (token_id, doc) ordering.
    """
    options = options or IndexOptions()
    n = int(n_docs)
    if n == 0:
        return _empty_segment(options)
    if payloads is None:
        payloads = np.arange(n, dtype=np.int64)
    payloads = np.asarray(payloads, dtype=np.int64)
    if payloads.shape != (n,):
        raise ValueError("payloads must be one int64 per document")

    if token_ids is not None:
        if not presorted:
            raise ValueError("token_ids path requires presorted postings")
        if vocab_keys is None:
            raise ValueError("token_ids requires vocab_keys")
        all_ids = np.asarray(token_ids, dtype=np.int64)
        all_keys = None
        total = all_ids.size
    else:
        all_keys = np.asarray(keys, dtype=f"S{WIDTH}")
        all_ids = None
        total = all_keys.size
    all_docs = np.asarray(doc_ids, dtype=np.int64)
    all_tfs = np.asarray(tfs, dtype=np.int64)

    # Pass 1 — records: doc lengths -> fieldnorms, N, Σdl (flush.rs:49-64).
    lengths = np.zeros(n, dtype=np.int64)
    np.add.at(lengths, all_docs, np.minimum(all_tfs, 0xFFFFFFFF))
    lengths = np.minimum(lengths, 0xFFFFFFFF)
    fieldnorms = length_to_fieldnorm(lengths)
    sum_dl = int(lengths.sum())
    if progress is not None:
        progress("records", n, n)

    if total == 0:
        seg = _empty_segment(options)
        seg.n_docs = n
        seg.sum_dl = sum_dl
        seg.doc_fieldnorm = fieldnorms.astype(np.uint8)
        seg.doc_payload = payloads
        return seg

    if total >= 2**31:
        raise ValueError(
            "corpus exceeds int32 posting addressing (2^31 postings); "
            "shard the corpus across devices"
        )
    if presorted:
        s_keys, s_docs, s_tfs = all_keys, all_docs, all_tfs
        s_ids = all_ids
    else:
        s_ids = None
        # Sorting 16-byte strings directly is memcmp-bound; reinterpret
        # each key as two big-endian uint64 columns (numeric order ==
        # byte-lexicographic order) and lexsort integer passes instead.
        import sys as _sys

        k2 = np.ascontiguousarray(all_keys).view(np.uint64).reshape(-1, 2)
        if _sys.byteorder == "little":
            hi = k2[:, 0].byteswap()
            lo = k2[:, 1].byteswap()
        else:
            hi, lo = k2[:, 0], k2[:, 1]
        # doc_grouped actually requires globally ASCENDING doc ids (the
        # stable key sort then yields (key, doc) order); fall back to the
        # full lexsort when the input violates that.
        if doc_grouped and (
            all_docs.size < 2 or bool(np.all(all_docs[:-1] <= all_docs[1:]))
        ):
            order = np.lexsort((lo, hi))
        else:
            order = np.lexsort((all_docs, lo, hi))
        s_keys = all_keys[order]
        s_docs = all_docs[order]
        s_tfs = all_tfs[order]
    if progress is not None:
        progress("sort", total, total)

    # Token run-lengths -> token table.
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    if s_ids is not None:
        boundary[1:] = s_ids[1:] != s_ids[:-1]
        token_first = np.flatnonzero(boundary)
        token_keys = np.asarray(vocab_keys, dtype=f"S{WIDTH}")[
            s_ids[token_first]
        ]
    else:
        boundary[1:] = s_keys[1:] != s_keys[:-1]
        token_first = np.flatnonzero(boundary)
        token_keys = s_keys[token_first]
    v = token_keys.size
    token_df = np.diff(np.append(token_first, total)).astype(np.int64)

    # Cut each token's run into 128-posting blocks (flush.rs:68-136).
    token_of_posting = np.cumsum(boundary) - 1
    rank_in_token = np.arange(total, dtype=np.int64) - token_first[token_of_posting]
    blocks_per_token = (token_df + BLOCK - 1) // BLOCK
    token_block_start = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(blocks_per_token, out=token_block_start[1:])
    b = int(token_block_start[-1])
    block_of_posting = token_block_start[token_of_posting] + rank_in_token // BLOCK
    slot_in_block = rank_in_token % BLOCK

    # Padded block data.
    block_docids = np.full((b, BLOCK), n, dtype=np.int32)
    block_tfs = np.zeros((b, BLOCK), dtype=np.int32)
    block_docids[block_of_posting, slot_in_block] = s_docs
    block_tfs[block_of_posting, slot_in_block] = s_tfs

    # Block metadata: doc ranges and sizes.
    block_n = np.zeros(b, dtype=np.int64)
    np.add.at(block_n, block_of_posting, 1)
    block_min_doc = block_docids[:, 0].astype(np.int64)
    block_max_doc = block_docids[np.arange(b), block_n - 1].astype(np.int64)

    # Max-impact (Wand) pairs, first-maximum semantics (bm25.rs:297-332).
    avgdl = float(sum_dl) / float(n)
    post_fn = fieldnorms[s_docs].astype(np.int64)
    # s1-table factorization (the Cache trick, bm25.rs:334-359): the
    # per-posting score is t*(k1+1)/(t + s1[fn]) with a 256-entry f64
    # table — bit-identical to the inline formula (same IEEE ops on the
    # same values) at a fraction of the flops/temps of tf_score over
    # tens of millions of postings.
    s1_table = ScoreTables.create(options.k1, options.b, n, sum_dl).s1_table
    t64 = s_tfs.astype(np.float64)
    post_score = t64 * (options.k1 + 1.0) / (t64 + s1_table[post_fn])
    # First index attaining the per-block max: postings are grouped by
    # block, so a per-group reduceat max + first equality hit replaces
    # the previous (block, -score, idx) lexsort over all postings
    # (single passes instead of an O(P log P) 3-key sort).
    block_starts = np.searchsorted(
        block_of_posting, np.arange(b), side="left"
    )
    gmax = np.maximum.reduceat(post_score, block_starts)
    hit = np.flatnonzero(post_score == gmax[block_of_posting])
    first_of_block = hit[
        np.searchsorted(block_of_posting[hit], np.arange(b), side="left")
    ]
    block_wand_fn = post_fn[first_of_block].astype(np.uint8)
    block_wand_tf = s_tfs[first_of_block].astype(np.int32)

    # Token-level Wand = first block attaining the per-token max block score
    # (equivalent to pushing every posting: earlier blocks with strictly
    # smaller maxima cannot win, and within the winning block the block pair
    # is already the first-attaining posting).
    block_token = np.repeat(np.arange(v, dtype=np.int64), blocks_per_token)
    bidx = np.arange(b, dtype=np.int64)
    bscore = tf_score(
        block_wand_fn.astype(np.int64), block_wand_tf, options.k1, options.b, avgdl
    )
    selt = np.lexsort((bidx, -bscore, block_token))
    first_of_token = selt[
        np.searchsorted(block_token[selt], np.arange(v), side="left")
    ]
    token_wand_fn = block_wand_fn[first_of_token]
    token_wand_tf = block_wand_tf[first_of_token]
    if progress is not None:
        progress("write", b, b)

    return SealedSegment(
        options=options,
        n_docs=n,
        sum_dl=sum_dl,
        doc_fieldnorm=fieldnorms.astype(np.uint8),
        doc_payload=payloads,
        token_keys=token_keys,
        token_df=token_df.astype(np.int32),
        token_wand_fn=token_wand_fn,
        token_wand_tf=token_wand_tf,
        token_block_start=token_block_start.astype(np.int32),
        block_min_doc=block_min_doc.astype(np.int32),
        block_max_doc=block_max_doc.astype(np.int32),
        block_n=block_n.astype(np.int32),
        block_wand_fn=block_wand_fn,
        block_wand_tf=block_wand_tf,
        block_docids=block_docids,
        block_tfs=block_tfs,
    )


def segment_from_reference(seg) -> SealedSegment:
    """The port's ``SealedSegment`` holding a copy of another segment's
    fields: a segment built by the JAX package (or read from one of its
    checkpoints) crosses into the port by value, never as its class.  A
    port segment is returned as it is."""
    if isinstance(seg, SealedSegment):
        return seg
    arrays = {
        f.name: np.array(getattr(seg, f.name))
        for f in fields(SealedSegment)
        if f.name not in ("options", "n_docs", "sum_dl")
    }
    return SealedSegment(
        options=IndexOptions(k1=seg.options.k1, b=seg.options.b),
        n_docs=int(seg.n_docs),
        sum_dl=int(seg.sum_dl),
        **arrays,
    )
