"""Delta-compressed posting stream: the equal-index-memory layout.

The reference serves queries directly from bit/byte-packed 128-posting
blocks, decompressing each block on seek into a fixed buffer
(the reference extension's crates/bm25/src/compression.rs:36-136,
search.rs:498-518).  This module is the TPU-native equivalent: postings
are stored as byte-width-adaptive doc-id deltas plus term frequencies,
and the query kernels decompress them *in registers* — a uniform word
gather, static byte/halfword extraction, and a masked lane cumsum
anchored at a per-window base doc id.  No decompressed copy of the
index ever exists in HBM.

Layout
------
Each term's (doc-ascending) postings are cut into WINDOWS of at most
128 postings.  Per window:

- doc deltas are stored at a per-window bit width ``dbits`` in
  {2, 4, 8, 16} (chosen from the window's largest delta); every window's
  doc data fits 32 u32 words (128 B), so 16-bit windows hold at most
  64 postings — the kernels always gather exactly 32 words per window;
  the window's tf words follow its doc words in the same stream, so a
  single per-window offset (plus the meta-derived doc word count)
  addresses both sides;
- the window's first doc id is kept as an uncompressed 32-bit base
  (lane 0's stored delta is 0 and never read), so windows are
  independently decodable — the SummaryTuple-style re-anchoring that
  lets the engine jump into the middle of a posting list;
- term frequencies are stored at a per-window bit width ``tfbits`` in
  {0, 2, 4, 8, 16}: 0 means every tf in the window is 1 (the dominant
  case — nothing is stored);
- deltas larger than 65535 force a window split (the next window
  re-anchors), so 16 bits always suffice.

Sub-byte widths matter at scale: on a multi-million-doc corpus a
common term's doc gaps are mostly <= 15 (4-bit) and its tfs <= 3
(2-bit), which is where the reference's bit-packer also operates
(compression.rs bitwidth from block maxima); byte-granular packing
would floor at ~2x the reference's bytes.

Scores are reconstructed on the VPU per posting as
``tf * s0 / (tf + s1[fieldnorm])`` — the reference's per-posting
``Cache.evaluate`` (bm25.rs:334-359) — with the term's s0 shipped per
window by the host and the 256-entry s1 table resident in VMEM.
Everything is lossless: ranks are exactly the float32 oracle's.

Memory: ~0.5-1.1 B/posting doc side + ~0-0.5 B/posting tf side on
typical corpora, plus 2 B/doc (fieldnorm u16 with a deleted bit) —
below the reference's block format plus 8 B/doc DocumentTuple
(utils/memparity.py accounting).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils import tracing
from .sealed import SealedSegment

__all__ = [
    "StreamIndex",
    "build_stream_index",
    "save_stream_index",
    "load_stream_index",
    "WINDOW",
]

WINDOW = 128  # max postings per window (64 at wd=2); = reference BLOCK

# Sub-chunk granularity: windows are assembled from 64-posting halves so
# a u16 window never needs more than 32 words of doc data.
_SUB = 64

_DELETED_BIT = np.uint16(1 << 8)  # doc_fn bit 8 = deleted


@dataclass
class StreamIndex:
    """Host-side compressed stream + per-window metadata over one
    sealed segment.  Device uploads happen in search.stream."""

    n_docs: int
    n_tokens: int
    n_postings: int
    tf_width: int  # corpus-level max tf storage class: 1 or 2 bytes

    # One interleaved bit stream (u32-word aligned; 64 words of zero
    # tail padding): per window, the doc-delta words immediately
    # followed by the tf words — the tf offset is derived from the
    # window's meta (len, dbits), so windows carry ONE offset.
    words: np.ndarray  # [S] uint32

    # Per-window metadata ([W] entries, term-major, doc-ascending).
    w_token: np.ndarray  # [W] int32
    w_base: np.ndarray  # [W] int32 first doc id
    w_len: np.ndarray  # [W] int32 (1..=128; <=64 when dbits/tfbits=16)
    w_dbits: np.ndarray  # [W] uint8 in {2, 4, 8, 16}
    w_tfbits: np.ndarray  # [W] uint8 in {0, 2, 4, 8, 16}
    w_off4: np.ndarray  # [W] int32 word offset into words
    w_s0: np.ndarray  # [W] float32 term s0 = idf*(k1+1)
    w_maximp: np.ndarray  # [W] float32 max posting impact (MaxScore bound)

    # CSR: token id -> window span.
    token_w_start: np.ndarray  # [V+1] int64

    # Doc table: fieldnorm | deleted bit (uploaded as-is).
    doc_fn: np.ndarray  # [N+1] uint16 (pad slot N: deleted)

    # Per-token max single-posting impact (term upper bound for
    # MaxScore term ordering; the TokenTuple wand pair analog).
    token_maximp: np.ndarray  # [V] float32

    s1_table: np.ndarray  # [256] float32

    # Packed per-window meta for fast host prep:
    # len | dbits<<8 | tfbits<<16.
    w_meta: np.ndarray = None  # [W] int32

    def __post_init__(self):
        if self.w_meta is None:
            self.w_meta = (
                self.w_len.astype(np.int32)
                | (self.w_dbits.astype(np.int32) << 8)
                | (self.w_tfbits.astype(np.int32) << 16)
            )

    @property
    def n_windows(self) -> int:
        return int(self.w_len.size)

    def w_meta16(self) -> np.ndarray:
        """Device meta: len(8) | log2(dbits)-1 (2) | tf class (3) packed
        u16 — half the i32 host form (w_meta keeps raw widths for
        dispatch-time specialization)."""
        dclass = np.log2(self.w_dbits.astype(np.int64)).astype(
            np.int64
        ) - 1  # 2,4,8,16 -> 0..3
        tfb = self.w_tfbits.astype(np.int64)
        tclass = np.where(tfb == 0, 0, np.log2(np.maximum(tfb, 2)).astype(np.int64))
        # tfbits 0,2,4,8,16 -> class 0,1,2,3,4
        return (
            self.w_len.astype(np.int64)
            | (dclass << 8)
            | (tclass << 10)
        ).astype(np.uint16)

    def device_bytes(self) -> dict:
        """What the engine keeps resident in HBM (equal-index-memory
        accounting; host copies of the same arrays are build/mutation
        state, mirroring the reference's on-disk segment)."""
        postings = self.words.nbytes
        doc_tables = self.doc_fn.nbytes
        return {
            "postings": postings,
            "doc_tables": doc_tables,
            "s1_table": self.s1_table.nbytes,
            "total": postings + doc_tables + self.s1_table.nbytes,
            "bytes_per_posting": postings / max(1, self.n_postings),
        }

    def decode_window(self, w: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host reference decoder (tests / lookups): (docs, tfs) of
        window w — must round-trip the sealed segment's postings."""
        ln = int(self.w_len[w])
        dbits = int(self.w_dbits[w])
        off = int(self.w_off4[w])
        deltas = _extract_bits(self.words, off, ln, dbits)
        deltas[0] = 0
        docs = int(self.w_base[w]) + np.cumsum(deltas)
        tfbits = int(self.w_tfbits[w])
        if tfbits == 0:
            tfs = np.ones(ln, dtype=np.int64)
        else:
            toff = off + ((ln * dbits + 31) >> 5)
            tfs = _extract_bits(self.words, toff, ln, tfbits)
        return docs, tfs


_STREAM_ARRAYS = (
    "words", "w_token", "w_base", "w_len", "w_dbits", "w_tfbits",
    "w_off4", "w_s0", "w_maximp", "token_w_start", "doc_fn",
    "token_maximp", "s1_table",
)


def save_stream_index(si: StreamIndex, path: str) -> None:
    """Persist the built stream (one npz).  Building the stream over a
    multi-hundred-million-posting segment is ~20 min of host work at
    8.4M docs; reloading is seconds, so benches/tools cache it next to
    the segment (`bench.py --cache`)."""
    np.savez(
        path,
        scalars=np.array(
            [si.n_docs, si.n_tokens, si.n_postings, si.tf_width],
            dtype=np.int64,
        ),
        **{f: getattr(si, f) for f in _STREAM_ARRAYS},
    )


def load_stream_index(path: str) -> StreamIndex:
    z = np.load(path)
    n_docs, n_tokens, n_postings, tf_width = (
        int(x) for x in z["scalars"]
    )
    return StreamIndex(
        n_docs=n_docs,
        n_tokens=n_tokens,
        n_postings=n_postings,
        tf_width=tf_width,
        **{f: z[f] for f in _STREAM_ARRAYS},
    )


def _extract_bits(
    words: np.ndarray, off4: int, n: int, bits: int
) -> np.ndarray:
    """Host-side unpack of n values at `bits` width (2/4/8/16, dividing
    32 — values never straddle word boundaries) from word offset off4."""
    lane = np.arange(n, dtype=np.int64)
    bitpos = lane * bits
    w = words[off4 + (bitpos >> 5)].astype(np.int64)
    return (w >> (bitpos & 31)) & ((1 << bits) - 1)


def _bits_class(maxv: np.ndarray, classes) -> np.ndarray:
    """Smallest width from `classes` (ascending) holding each max value."""
    out = np.full(maxv.shape, classes[-1], dtype=np.int64)
    for b in reversed(classes[:-1]):
        out = np.where(maxv <= (1 << b) - 1, b, out)
    return out


@tracing.traced("vcbm25.build.stream")
def build_stream_index(
    seg: SealedSegment, global_stats: Optional[tuple] = None
) -> StreamIndex:
    """Derive the compressed stream from a sealed segment (vectorized).

    global_stats: optional (n_docs_total, sum_dl_total, token_s0 [V])
    so doc-sharded segments bake global idf/avgdl into s0/s1 exactly as
    the other engines do (parallel builds compute statistics globally,
    reference am_build.rs:353-527).
    """
    from ..models.scoring import ScoreTables

    if global_stats is not None:
        n_total, sum_dl_total, s0 = global_stats
        tables = ScoreTables.create(
            seg.options.k1, seg.options.b, n_total, sum_dl_total
        )
        s0 = np.asarray(s0, dtype=np.float64)
    else:
        tables = seg.score_tables()
        s0 = seg.token_s0()
    s1_table = tables.s1_table.astype(np.float32)

    n = seg.n_docs
    v = seg.n_tokens
    tok, doc, tfv = seg.postings()
    p = int(tok.size)

    doc_fn = np.full(n + 1, _DELETED_BIT, dtype=np.uint16)
    doc_fn[:n] = seg.doc_fieldnorm.astype(np.uint16)

    if p == 0:
        return StreamIndex(
            n_docs=n,
            n_tokens=v,
            n_postings=0,
            tf_width=1,
            words=np.zeros(64, dtype=np.uint32),
            w_token=np.zeros(0, dtype=np.int32),
            w_base=np.zeros(0, dtype=np.int32),
            w_len=np.zeros(0, dtype=np.int32),
            w_dbits=np.zeros(0, dtype=np.uint8),
            w_tfbits=np.zeros(0, dtype=np.uint8),
            w_off4=np.zeros(0, dtype=np.int32),
            w_s0=np.zeros(0, dtype=np.float32),
            w_maximp=np.zeros(0, dtype=np.float32),
            token_w_start=np.zeros(v + 1, dtype=np.int64),
            doc_fn=doc_fn,
            token_maximp=np.zeros(v, dtype=np.float32),
            s1_table=s1_table,
        )

    doc64 = doc.astype(np.int64)
    tf64 = tfv.astype(np.int64)
    tf_max = int(tf64.max())
    if tf_max > 0xFFFF:
        raise ValueError(
            f"stream layout stores term frequencies in at most 16 bits "
            f"(max tf here: {tf_max})"
        )
    tf_width = 1 if tf_max <= 0xFF else 2

    # Deltas to the previous posting within a term (term starts: 0).
    term_start = np.empty(p, dtype=bool)
    term_start[0] = True
    term_start[1:] = tok[1:] != tok[:-1]
    delta = np.zeros(p, dtype=np.int64)
    delta[1:] = doc64[1:] - doc64[:-1]
    delta[term_start] = 0

    # Runs: maximal spans whose interior deltas fit u16 (a larger gap
    # re-anchors — the next window stores the doc id absolutely).
    run_start = term_start | (delta > 0xFFFF)
    run_first = np.flatnonzero(run_start)
    pos_in_run = np.arange(p, dtype=np.int64) - np.repeat(
        run_first, np.diff(np.append(run_first, p))
    )

    # 64-posting sub-chunks within runs.
    sub_start = run_start | (pos_in_run % _SUB == 0)
    sub_first = np.flatnonzero(sub_start)
    n_sub = sub_first.size
    sub_len = np.diff(np.append(sub_first, p))
    sub_of = np.cumsum(sub_start) - 1

    # Width decision inputs: per sub-chunk, the max INTERIOR delta
    # (excluding the sub-chunk's first posting, whose delta is only
    # used when the sub-chunk is merged into the previous one) and the
    # first ("linking") delta.
    d_tail = delta.copy()
    d_tail[sub_first] = 0
    sub_maxin = np.maximum.reduceat(d_tail, sub_first)
    sub_link = delta[sub_first]
    sub_is_run_start = run_start[sub_first]

    # Pair even sub-chunks (within their run) with their successor into
    # one 128-posting window when the combined deltas and tfs fit 8
    # bits (128 lanes x 8 bits = the kernels' fixed 32-word gather).
    sub_tfmax = np.maximum.reduceat(tf64, sub_first)
    run_of_sub = np.cumsum(sub_is_run_start) - 1
    sub_idx_in_run = np.arange(n_sub, dtype=np.int64) - np.repeat(
        np.flatnonzero(sub_is_run_start),
        np.diff(np.append(np.flatnonzero(sub_is_run_start), n_sub)),
    )
    even = sub_idx_in_run % 2 == 0
    has_next = np.zeros(n_sub, dtype=bool)
    has_next[:-1] = run_of_sub[:-1] == run_of_sub[1:]
    merge = np.zeros(n_sub, dtype=bool)
    cand = even & has_next
    nxt = np.flatnonzero(cand) + 1
    merge[cand] = (
        (sub_maxin[cand] <= 0xFF)
        & (sub_link[nxt] <= 0xFF)
        & (sub_maxin[nxt] <= 0xFF)
        & (sub_tfmax[cand] <= 0xFF)
        & (sub_tfmax[nxt] <= 0xFF)
    )
    # A sub-chunk is a window start unless it is merged into the
    # previous (even) one.
    absorbed = np.zeros(n_sub, dtype=bool)
    absorbed[1:] = merge[:-1]
    win_start_sub = ~absorbed

    win_sub_first = np.flatnonzero(win_start_sub)
    n_win = win_sub_first.size
    # Per-window posting span.
    w_first = sub_first[win_sub_first]
    w_len = np.diff(np.append(w_first, p)).astype(np.int64)
    assert int(w_len.max()) <= WINDOW

    # Stored deltas: window lane 0 holds 0 (the base anchors it).
    win_start_post = sub_start & win_start_sub[sub_of]
    win_of = np.cumsum(win_start_post) - 1  # window id per posting
    lane = np.arange(p, dtype=np.int64) - w_first[win_of]
    d_store = delta.copy()
    d_store[lane == 0] = 0

    # Per-window bit widths from the window maxima (the reference picks
    # bitwidth per 128-block the same way, compression.rs:36-51; we
    # quantize to shift-friendly classes).
    w_dmax = np.maximum.reduceat(d_store, w_first)
    w_dbits = _bits_class(w_dmax, (2, 4, 8, 16))
    w_tfmax = np.maximum.reduceat(tf64, w_first)
    w_tfbits = np.where(
        w_tfmax <= 1, 0, _bits_class(w_tfmax, (2, 4, 8, 16))
    )
    # 16-bit windows are single sub-chunks (<= 64 postings) by the
    # merge rule, so every window fits the 32-word gather.
    assert int((w_len * w_dbits).max()) <= 1024
    assert int((w_len * w_tfbits).max()) <= 1024

    # Word layout: one interleaved stream, each window's doc words
    # immediately followed by its tf words (both word-aligned), so one
    # offset addresses both — the tf offset is doc_off + ceil(len*dbits/32).
    doc_words_per_w = (w_len * w_dbits + 31) >> 5
    tf_words_per_w = (w_len * w_tfbits + 31) >> 5
    words_per_w = doc_words_per_w + tf_words_per_w
    w_off4 = np.zeros(n_win, dtype=np.int64)
    np.cumsum(words_per_w[:-1], out=w_off4[1:])
    s_words = int(words_per_w.sum()) + 64
    if 4 * s_words >= 2**31:
        raise ValueError(
            "stream exceeds int32 byte addressing (2 GiB); shard the "
            "corpus across devices"
        )

    words = np.zeros(s_words, dtype=np.uint32)

    # Bit-pack both streams: value v of lane l lands in word
    # off4 + (l*bits)>>5 shifted by (l*bits)&31; widths divide 32, so
    # values never straddle words and per-lane slots are disjoint
    # (bitwise-or == add).
    dbitpos = lane * w_dbits[win_of]
    np.add.at(
        words,
        w_off4[win_of] + (dbitpos >> 5),
        (
            (d_store.astype(np.uint64) << (dbitpos & 31).astype(np.uint64))
            & np.uint64(0xFFFFFFFF)
        ).astype(np.uint32),
    )
    t_sel = w_tfbits[win_of] > 0
    tbitpos = lane[t_sel] * w_tfbits[win_of][t_sel]
    np.add.at(
        words,
        (w_off4 + doc_words_per_w)[win_of][t_sel] + (tbitpos >> 5),
        (
            (
                tf64[t_sel].astype(np.uint64)
                << (tbitpos & 31).astype(np.uint64)
            )
            & np.uint64(0xFFFFFFFF)
        ).astype(np.uint32),
    )

    # Per-window metadata.
    w_token = tok[w_first].astype(np.int32)
    w_base = doc64[w_first].astype(np.int32)
    s0f = s0.astype(np.float64)
    w_s0 = s0f[w_token].astype(np.float32)

    # Exact per-posting impacts (float64 -> f32 max) for MaxScore
    # bounds: bound must dominate the device's f32 arithmetic, so pad
    # by a few ulps like ranges.py does.
    fn = seg.doc_fieldnorm[doc64].astype(np.int64)
    imp = (tf64.astype(np.float64) * s0f[tok]) / (
        tf64 + tables.s1_table[fn]
    )
    w_maximp = np.maximum.reduceat(imp, w_first)
    w_maximp = np.nextafter(
        (w_maximp * (1.0 + 1e-6)).astype(np.float32), np.float32(np.inf)
    )
    token_maximp = np.zeros(v, dtype=np.float32)
    tstarts = np.flatnonzero(term_start)
    t_max = np.maximum.reduceat(imp, tstarts)
    t_max = np.nextafter(
        (t_max * (1.0 + 1e-6)).astype(np.float32), np.float32(np.inf)
    )
    token_maximp[tok[tstarts]] = t_max

    # CSR token -> windows (windows are term-major by construction).
    token_w_start = np.zeros(v + 1, dtype=np.int64)
    np.add.at(token_w_start, w_token.astype(np.int64) + 1, 1)
    np.cumsum(token_w_start, out=token_w_start)

    return StreamIndex(
        n_docs=n,
        n_tokens=v,
        n_postings=p,
        tf_width=tf_width,
        words=words,
        w_token=w_token,
        w_base=w_base,
        w_len=w_len.astype(np.int32),
        w_dbits=w_dbits.astype(np.uint8),
        w_tfbits=w_tfbits.astype(np.uint8),
        w_off4=w_off4.astype(np.int32),
        w_s0=w_s0,
        w_maximp=w_maximp,
        token_w_start=token_w_start,
        doc_fn=doc_fn,
        token_maximp=token_maximp,
        s1_table=s1_table,
    )
