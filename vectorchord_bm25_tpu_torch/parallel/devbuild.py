"""Device-side sharded index build on one card (counterpart of
``parallel/devbuild.py``).

The reference's parallel build fans the corpus out to Postgres DSM
workers that each sort their shard's (token, doc, tf) mappings and then
k-way merge with doc-id offset rebasing
(src/index/bm25/am/am_build.rs:353-527, crates/bm25/src/io.rs:244-282).
The JAX package runs the expensive parts on a device mesh, one shard a
device; the port stacks the shards along the leading dimension of six
``[D, P]`` columns on one card:

- the per-shard posting sort is ONE call of D1-sort
  (``ops/shard_kernels.py:posting_sort``, ``csrc/posting_sort.cu``), every
  shard's row sorted on its own; the rows are staged doc-grouped in
  ascending doc, so its radix sort skips the doc passes;
- 16-byte keys sort as four big-endian u32 columns (numeric order ==
  byte-lexicographic order, the same trick the host build uses), with
  doc id as a fifth sort key, so the device order is bit-identical to
  the host lexsort;
- global doc-id offsets are an exclusive scan of shard doc counts
  (SH-stats, ``shard_stats``) — the DSM shared-counter analog;
- the global token table (union vocabulary, summed df) is a host
  exchange over the per-shard sorted key runs, exactly like the
  reference leader's merge of worker runs.

Block cutting / Wand metadata over each shard's sorted run stays the
vectorized numpy flush (index/sealed.py), one shard at a time.  The host
code (key columns, staging, flush) is the reference's, copied.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np
import torch

from ..index.sealed import SealedSegment, build_sealed_segment_from_postings
from ..ops.shard_kernels import posting_sort, shard_stats
from ..text.intern import WIDTH, Document
from ..utils.buckets import bucket_pow2
from ..utils.device import as_device
from ..utils.options import IndexOptions

__all__ = [
    "build_shards_on_device",
    "build_shards_on_device_from_postings",
    "device_doc_offsets",
]


def _keys_to_u64_cols(keys: np.ndarray):
    """16-byte keys -> (hi, lo) uint64 columns whose numeric order is the
    byte-lexicographic key order."""
    k2 = np.ascontiguousarray(keys.astype(f"S{WIDTH}")).view(np.uint64)
    k2 = k2.reshape(-1, 2)
    if sys.byteorder == "little":
        return k2[:, 0].byteswap(), k2[:, 1].byteswap()
    return k2[:, 0].copy(), k2[:, 1].copy()


def _u64_cols_to_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    if sys.byteorder == "little":
        hi, lo = hi.byteswap(), lo.byteswap()
    out = np.empty((hi.size, 2), dtype=np.uint64)
    out[:, 0] = hi
    out[:, 1] = lo
    return out.reshape(-1).view(f"S{WIDTH}")


def device_doc_offsets(counts: np.ndarray, device="cuda") -> np.ndarray:
    """Exclusive scan of per-shard doc counts on ``device`` — the doc-id
    offset rebasing of io.rs:244-282, through SH-stats (whose f64 sums over
    zero-width rows are unused here)."""
    dev = as_device(device)
    d = counts.size
    _, offsets = shard_stats(
        torch.zeros((d, 0), dtype=torch.uint8, device=dev),
        torch.zeros((d, 0), dtype=torch.float32, device=dev),
        torch.from_numpy(np.asarray(counts, dtype=np.int64)).to(dev),
    )
    return offsets[:d].cpu().numpy()


def _documents_to_shard_cols(documents, bounds):
    """Host scan phase (the worker heap-scan analog): flatten each
    shard's (key, doc, tf) postings into u64-column form."""
    n_shards = len(bounds) - 1
    shard_cols = []
    for i in range(n_shards):
        lo_b, hi_b = int(bounds[i]), int(bounds[i + 1])
        docs = documents[lo_b:hi_b]
        counts = np.fromiter(
            (len(d) for d in docs), dtype=np.int64, count=len(docs)
        )
        total = int(counts.sum())
        if total:
            keys = np.concatenate([d.keys for d in docs]).astype(f"S{WIDTH}")
            tfs = np.concatenate([d.values for d in docs]).astype(np.uint32)
        else:
            keys = np.zeros(0, dtype=f"S{WIDTH}")
            tfs = np.zeros(0, dtype=np.uint32)
        doc_of = np.repeat(np.arange(len(docs), dtype=np.int32), counts)
        hi_col, lo_col = _keys_to_u64_cols(keys)
        shard_cols.append((hi_col, lo_col, doc_of, tfs, len(docs)))
    return shard_cols


def _postings_to_shard_cols(keys, doc_ids, tfs, doc_start, bounds):
    """Shard columns from flat doc-grouped postings (the scale path —
    no per-document Python objects): slice the CSR at the shard bounds
    and rebase doc ids to shard-local."""
    n_shards = len(bounds) - 1
    keys = np.asarray(keys, dtype=f"S{WIDTH}")
    doc_ids = np.asarray(doc_ids, dtype=np.int64)
    tfs = np.asarray(tfs)
    doc_start = np.asarray(doc_start, dtype=np.int64)
    shard_cols = []
    for i in range(n_shards):
        lo_b, hi_b = int(bounds[i]), int(bounds[i + 1])
        p0, p1 = int(doc_start[lo_b]), int(doc_start[hi_b])
        hi_col, lo_col = _keys_to_u64_cols(keys[p0:p1])
        shard_cols.append(
            (
                hi_col,
                lo_col,
                (doc_ids[p0:p1] - lo_b).astype(np.int32),
                tfs[p0:p1].astype(np.uint32),
                hi_b - lo_b,
            )
        )
    return shard_cols


def build_shards_on_device(
    documents: Sequence[Document],
    bounds: np.ndarray,
    payloads: np.ndarray,
    options: IndexOptions,
    device="cuda",
) -> List[SealedSegment]:
    """Build one sealed segment per shard, sorting every shard's postings
    on ``device`` in one launch.  Bit-identical to the host per-shard
    build (ShardedIndex.build(device_build=False))."""
    return _build_shards_from_cols(
        _documents_to_shard_cols(documents, bounds),
        bounds, payloads, options, device,
    )


def build_shards_on_device_from_postings(
    keys, doc_ids, tfs, doc_start,
    bounds: np.ndarray,
    payloads: np.ndarray,
    options: IndexOptions,
    device="cuda",
) -> List[SealedSegment]:
    """build_shards_on_device for flat doc-grouped postings (keys [P]
    |S16, doc_ids [P], tfs [P], doc_start [N+1] CSR) — the
    heap-scan-free scale path used by large builds."""
    return _build_shards_from_cols(
        _postings_to_shard_cols(keys, doc_ids, tfs, doc_start, bounds),
        bounds, payloads, options, device,
    )


def _build_shards_from_cols(
    shard_cols,
    bounds: np.ndarray,
    payloads: np.ndarray,
    options: IndexOptions,
    device="cuda",
) -> List[SealedSegment]:
    dev = as_device(device)
    n_shards = len(bounds) - 1

    # Per-shard staging: each shard's six padded [P] rows are built on the
    # host and copied straight into its row of the six [D, P] device
    # columns — the host never materializes a dense [D, Pmax] stack
    # (O(max-shard) host staging; am_build.rs workers likewise each hold
    # only their own run).  Pad postings carry the maximal key so the sort
    # pushes them to the tail; the two u64 key columns split into four u32
    # columns (numeric order is preserved column-major), held as int32
    # bits.
    p_needed = max(max(c[0].size for c in shard_cols), 1)
    pmax = bucket_pow2(p_needed, 8)  # a power of two, as D1-sort needs

    fills = (
        np.uint32(0xFFFFFFFF),
        np.uint32(0xFFFFFFFF),
        np.uint32(0xFFFFFFFF),
        np.uint32(0xFFFFFFFF),
        np.int32(np.iinfo(np.int32).max),
        np.uint32(0),
    )
    cols = [
        torch.empty((n_shards, pmax), dtype=torch.int32, device=dev)
        for _ in range(6)
    ]
    for i, (h, l, d_, t, _) in enumerate(shard_cols):
        host = (
            (h >> np.uint64(32)).astype(np.uint32),
            (h & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (l >> np.uint64(32)).astype(np.uint32),
            (l & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            d_.astype(np.int32),
            t.astype(np.uint32),
        )
        for j, (col, fill) in enumerate(zip(host, fills)):
            row = np.full(pmax, fill)
            row[: col.size] = col
            cols[j][i].copy_(torch.from_numpy(row.view(np.int32)))
            del row

    # One call sorts every shard's row: (key, doc) as five u32/i32 key
    # columns, tf carried — the per-worker sort_unstable of io.rs:90-98.
    # (key, doc) pairs are unique so the order is total and deterministic;
    # each row is doc-ascending with its pads last, which lets the sort skip
    # its four doc passes.
    posting_sort(cols)

    # Device doc-offset scan; must agree with the host bounds (the
    # contiguous-shard invariant).
    counts = np.asarray([c[4] for c in shard_cols], dtype=np.int64)
    offsets = device_doc_offsets(counts, dev)
    expect = np.cumsum(counts) - counts
    if not np.array_equal(offsets, expect):
        raise AssertionError(
            f"device offset scan disagrees with host: {offsets} vs {expect}"
        )

    # Flush phase per shard (flush.rs analog): pull each shard's sorted
    # run back one row at a time (host staging stays O(max-shard)), trim
    # the pad tail, and feed the vectorized block-cutting pipeline.
    payloads = np.asarray(payloads, dtype=np.int64)
    shards = []
    for i, (h, l, d_, t, n_docs) in enumerate(shard_cols):
        total = h.size
        row = [cols[j][i, :total].cpu().numpy() for j in range(6)]
        u32 = [r.view(np.uint32) for r in row]
        s_hi = (u32[0].astype(np.uint64) << np.uint64(32)) | u32[1].astype(
            np.uint64
        )
        s_lo = (u32[2].astype(np.uint64) << np.uint64(32)) | u32[3].astype(
            np.uint64
        )
        keys_sorted = _u64_cols_to_keys(s_hi, s_lo)
        lo_b = int(bounds[i])
        shards.append(
            build_sealed_segment_from_postings(
                keys_sorted,
                row[4].astype(np.int64),
                u32[5].astype(np.int64),
                n_docs,
                payloads=payloads[lo_b : lo_b + n_docs],
                options=options,
                presorted=True,
            )
        )
    del cols
    return shards
