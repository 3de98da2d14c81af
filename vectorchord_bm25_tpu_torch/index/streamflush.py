"""Streaming flush: sealed-segment construction from an on-disk sorted
posting run with bounded memory.

The reference's flush consumes its externally sorted mapping stream one
record at a time, so index build peak RAM is O(sort runs), not O(corpus)
(crates/bm25/src/flush.rs:40-190, io.rs:69-98).  The vectorized flush in
sealed.py materializes O(P) temporaries (~30 B/posting) — fine in-core,
but it makes `build_out_of_core` a misnomer.  This module is the
bounded-memory path: two chunked passes over the merged record file
(memmap windows), peak extra RAM = O(chunk) + the final segment arrays.

    pass 1: token boundaries + df (+ doc lengths) per chunk;
    allocate:  the final [B, 128] block arrays from Σ ceil(df/128);
    pass 2: scatter each chunk's postings into its blocks and fold the
            per-block max-impact (Wand) pairs with first-maximum
            semantics (strict-greater update preserves "first" across
            chunks because chunks arrive in posting order).

Produces bit-identical segments to build_sealed_segment_from_postings.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..models.fieldnorm import length_to_fieldnorm
from ..models.scoring import tf as tf_score
from ..text.intern import WIDTH
from ..utils.options import IndexOptions
from .sealed import BLOCK, SealedSegment, _empty_segment

__all__ = ["REC_DTYPE", "build_sealed_segment_streaming"]

REC_DTYPE = np.dtype([("key", f"S{WIDTH}"), ("doc", "<u4"), ("tf", "<u4")])


def build_sealed_segment_streaming(
    path: str,
    n_docs: int,
    payloads: Optional[Sequence[int]] = None,
    options: Optional[IndexOptions] = None,
    chunk_postings: int = 4_000_000,
    progress=None,
) -> SealedSegment:
    """Build from a (key, doc)-sorted record file without loading it.

    path: flat binary file of 24-byte records (key[16] | doc u32 | tf
    u32), sorted by (key, doc) — the native merge output.
    chunk_postings: window size per pass (memory knob; ~36 B/posting of
    transient arrays per window).
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

    total = os.path.getsize(path) // REC_DTYPE.itemsize
    if total >= 2**31:
        raise ValueError(
            "corpus exceeds int32 posting addressing (2^31 postings); "
            "shard the corpus across devices"
        )

    def read_chunk(lo: int, hi: int) -> np.ndarray:
        # Explicit offset reads, NOT memmap: mapped pages stay resident
        # after first touch, so a memmap sweep peaks RSS at O(file).
        return np.fromfile(
            path,
            dtype=REC_DTYPE,
            count=hi - lo,
            offset=lo * REC_DTYPE.itemsize,
        )

    # ------------------------------------------------------------------
    # Pass 1: doc lengths + token run boundaries, one window at a time.
    # ------------------------------------------------------------------
    lengths = np.zeros(n, dtype=np.int64)
    first_parts = []
    key_parts = []
    prev_key = None
    for lo in range(0, total, chunk_postings):
        hi = min(lo + chunk_postings, total)
        chunk = read_chunk(lo, hi)
        keys = chunk["key"]
        docs = chunk["doc"].astype(np.int64)
        tfs = chunk["tf"].astype(np.int64)
        np.add.at(lengths, docs, np.minimum(tfs, 0xFFFFFFFF))
        boundary = np.empty(keys.size, dtype=bool)
        boundary[0] = prev_key is None or keys[0] != prev_key
        boundary[1:] = keys[1:] != keys[:-1]
        first_parts.append(np.flatnonzero(boundary).astype(np.int64) + lo)
        key_parts.append(keys[boundary].copy())
        prev_key = keys[-1]
    lengths = np.minimum(lengths, 0xFFFFFFFF)
    fieldnorms = length_to_fieldnorm(lengths).astype(np.uint8)
    sum_dl = int(lengths.sum())
    if progress is not None:
        progress("records", n, n)

    if total == 0:
        seg = _empty_segment(options)
        seg.n_docs = n
        seg.sum_dl = sum_dl
        seg.doc_fieldnorm = fieldnorms
        seg.doc_payload = payloads
        return seg

    token_first = np.concatenate(first_parts)
    v = token_first.size
    token_keys = np.concatenate(key_parts)
    token_df = np.diff(np.append(token_first, total)).astype(np.int64)

    # ------------------------------------------------------------------
    # Allocate the final block structure (Σ ceil(df/128) blocks).
    # ------------------------------------------------------------------
    blocks_per_token = (token_df + BLOCK - 1) // BLOCK
    token_block_start = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(blocks_per_token, out=token_block_start[1:])
    b = int(token_block_start[-1])
    block_docids = np.full((b, BLOCK), n, dtype=np.int32)
    block_tfs = np.zeros((b, BLOCK), dtype=np.int32)
    # block_n is analytic: full except each token's last block.
    block_n = np.full(b, BLOCK, dtype=np.int64)
    last_block = token_block_start[1:] - 1
    block_n[last_block] = token_df - (blocks_per_token - 1) * BLOCK

    avgdl = float(sum_dl) / float(n)
    best_score = np.full(b, -np.inf, dtype=np.float64)
    block_wand_fn = np.zeros(b, dtype=np.uint8)
    block_wand_tf = np.zeros(b, dtype=np.int32)

    # ------------------------------------------------------------------
    # Pass 2: scatter postings into blocks; fold per-block Wand pairs.
    # ------------------------------------------------------------------
    for lo in range(0, total, chunk_postings):
        hi = min(lo + chunk_postings, total)
        m = hi - lo
        chunk = read_chunk(lo, hi)
        docs = chunk["doc"].astype(np.int64)
        tfs = chunk["tf"].astype(np.int64)
        gidx = np.arange(lo, hi, dtype=np.int64)
        tok_of = np.searchsorted(token_first, gidx, side="right") - 1
        rank = gidx - token_first[tok_of]
        blk = token_block_start[tok_of] + rank // BLOCK
        slot = rank % BLOCK
        block_docids[blk, slot] = docs
        block_tfs[blk, slot] = tfs

        post_fn = fieldnorms[docs].astype(np.int64)
        score = tf_score(post_fn, tfs, options.k1, options.b, avgdl)
        # Within-chunk first-max per block, then strict-greater fold into
        # the running best (chunks arrive in posting order, so a later
        # equal score never displaces an earlier one — bm25.rs:297-332).
        ublk, inv = np.unique(blk, return_inverse=True)
        sel = np.lexsort((np.arange(m), -score, inv))
        first = sel[np.searchsorted(inv[sel], np.arange(ublk.size))]
        better = score[first] > best_score[ublk]
        upd = ublk[better]
        best_score[upd] = score[first[better]]
        block_wand_fn[upd] = post_fn[first[better]].astype(np.uint8)
        block_wand_tf[upd] = tfs[first[better]].astype(np.int32)
        if progress is not None:
            progress("write", hi, total)

    block_min_doc = block_docids[:, 0].astype(np.int64)
    block_max_doc = block_docids[np.arange(b), block_n - 1].astype(np.int64)

    # Token-level Wand: first block attaining the per-token max block
    # score (same derivation as sealed.py).
    block_token = np.repeat(np.arange(v, dtype=np.int64), blocks_per_token)
    bidx = np.arange(b, dtype=np.int64)
    bscore = tf_score(
        block_wand_fn.astype(np.int64), block_wand_tf,
        options.k1, options.b, avgdl,
    )
    selt = np.lexsort((bidx, -bscore, block_token))
    first_of_token = selt[
        np.searchsorted(block_token[selt], np.arange(v), side="left")
    ]

    return SealedSegment(
        options=options,
        n_docs=n,
        sum_dl=sum_dl,
        doc_fieldnorm=fieldnorms,
        doc_payload=payloads,
        token_keys=token_keys.astype(f"S{WIDTH}"),
        token_df=token_df.astype(np.int32),
        token_wand_fn=block_wand_fn[first_of_token],
        token_wand_tf=block_wand_tf[first_of_token],
        token_block_start=token_block_start.astype(np.int32),
        block_min_doc=block_min_doc.astype(np.int32),
        block_max_doc=block_max_doc.astype(np.int32),
        block_n=block_n.astype(np.int32),
        block_wand_fn=block_wand_fn,
        block_wand_tf=block_wand_tf,
        block_docids=block_docids,
        block_tfs=block_tfs,
    )
