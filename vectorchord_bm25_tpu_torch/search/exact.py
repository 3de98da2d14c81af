"""Exact batched BM25 search and the scoring oracle (counterpart of
``search/exact.py``).

For each query, gathers *all* postings of all query terms, scatter-adds
their precomputed impacts into a per-query dense accumulator (or, in the
sparse strategy, sorts the gathered lanes by doc and sums each run) and
takes top-k.  Exact BM25, used as:

- the brute-force/oracle path (the reference's seqscan `<&>` ordering and
  the fuzz oracle, tests/fuzz:203-280);
- the rank-parity baseline for the pruned engine;
- HybridEngine's dense strategy.

Semantics pinned to the reference:
- query terms absent from the token table contribute nothing
  (search.rs:54-62);
- only documents with score > 0 are returned (Results starts with
  threshold 0.0, search.rs:81);
- ties broken by doc slot ascending (our pinned deterministic rule;
  the reference's heap leaves ties unspecified).

The host planning (``_win_lists``, ``_grp_lists``, the assembly, cost
buckets and caps of ``search_ids_async``) is a copy of the reference's
numpy, on a batch already looked up in the segment's token table
(``utils/batchkeys.py::batch_lookup``; ``search_async`` looks ``Query``
objects up);
the three jitted functions it dispatched to are ``ops/exact_kernel.py``
(E1-E3: CUDA kernels on a CUDA device, their plain versions on the CPU)
followed by ``ops/topk.py`` or the sparse reduction of
``ops/stream_sparse.py``.  ``oracle_scores`` and ``oracle_topk`` are the
reference's float oracles, copied unchanged.

The reference bounds its large dispatches in flight (``_throttle_large``,
``search/exact.py:38-66``) because JAX's async queue is unbounded and each
queued execution holds its transient device memory.  PyTorch's caching
allocator hands a dispatch its transient memory when it is enqueued and
reuses freed blocks in stream order, so queued dispatches do not pile up
memory and the throttle has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.ranges import build_range_index
from ..index.sealed import BLOCK, SealedSegment, segment_from_reference
from ..ops.exact_kernel import (
    exact_compact_accumulate,
    exact_dense_accumulate,
    exact_sparse_topk,
)
from ..ops.stream_sparse import ordinal_offsets
from ..ops.topk import dense_topk
from ..text.intern import Query
from ..utils.batchkeys import batch_lookup, group_positions
from ..utils.buckets import bucket_pow2 as _bucket
from ..utils.device import as_device
from ..utils.scorepack import pack_score
from .device import DeviceSegment
from .stream import StreamEngine

__all__ = ["ExactEngine", "oracle_scores", "oracle_topk"]

_INT_MAX = int(np.iinfo(np.int32).max)


def _score_and_topk(
    post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord,
    n_ord: int, filter_mask, k: int, n_docs: int,
):
    """The reference's ``_score_and_topk``: E1 with the filter multiplied
    into the sums as it writes them (``acc * filter``; None: no filter),
    then S2."""
    acc = exact_dense_accumulate(
        post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord,
        n_ord, n_docs, filter_mask=filter_mask,
    )
    return dense_topk(acc, k, n_docs)


def _score_and_topk_compact(
    post_impact, post_local, tr_range, tr_start, doc_live, filter_mask,
    grp_ids, grp_ord, n_ord: int, k: int, n_docs: int, range_size: int,
):
    """The reference's ``_score_and_topk_compact``: E3, live and filter
    multiplied in after the sum (the factors are per-doc, so they
    distribute over it), then S2."""
    acc = exact_compact_accumulate(
        post_impact, post_local, tr_range, tr_start, grp_ids, grp_ord, n_ord,
        n_docs, range_size,
    )
    acc.mul_(doc_live).mul_(filter_mask)  # (acc * live) * filter, in place
    return dense_topk(acc, k, n_docs)


class ExactEngine:
    """Batched exact search over one sealed segment, on torch.

    The dense per-query accumulator is [Q, n_docs] float32; to bound device
    memory, query batches are internally split so one dispatch's
    accumulator stays under `accumulator_budget` bytes (default 1 GiB)."""

    def __init__(
        self,
        segment: SealedSegment,
        device="cuda",
        accumulator_budget: int = 1 << 30,
        impact_dtype: str = "float32",
        compact: bool = False,
        share=None,
        strategy: str = "auto",
    ):
        """compact=True stores postings in the 5 B/posting flat form (the
        range index's impact/local streams) instead of the padded
        [B, 128] blocks — equal-index-memory mode.

        share: a BlockMaxEngine over the same segment; its device tensors
        (postings, range metadata, doc-live mask) are reused so a hybrid
        engine holds ONE copy of the index on the device.  Implies compact.

        strategy: "dense" = scatter-add accumulator + hierarchical
        top-k (cost ~ n_docs per query); "sparse" = doc-sort +
        segmented-sum over gathered postings only (cost ~ postings,
        independent of n_docs); "auto" picks sparse on corpora past
        `SPARSE_MIN_DOCS` where the accumulator passes dominate.
        Compact mode always uses its dense form.
        """
        if strategy not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.segment = segment
        self.accumulator_budget = accumulator_budget
        self.compact = bool(compact or share is not None)
        if share is not None:
            if share.segment is not segment:
                raise ValueError("share must wrap the same sealed segment")
            if share.dev_post_impact is None:
                raise ValueError(
                    "share requires a posting_mode='impact' BlockMaxEngine"
                )
            self.device = share.device
            self.dev = share.dev
            self._ranges = share.ranges
            self.dev_post_impact = share.dev_post_impact
            self.dev_post_local = share.dev_post_local
            self.dev_tr_range = share.dev_tr_range
            self.dev_tr_start = share.dev_tr_start
            return
        self.device = as_device(device)
        if self.compact:

            def put(x, dtype=None):
                return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
                    self.device
                )

            self.dev = DeviceSegment.from_sealed(
                segment, device=self.device, with_blocks=False
            )
            ri = build_range_index(segment)
            self._ranges = ri
            impact = put(ri.post_impact, np.float32)
            if impact_dtype == "bfloat16":
                # Round to nearest even, as the reference's jnp cast does.
                impact = impact.to(torch.bfloat16)
            self.dev_post_impact = impact
            self.dev_post_local = put(ri.post_local, np.uint8)
            self.dev_tr_range = put(np.append(ri.tr_range, _INT_MAX), np.int32)
            total = (
                int(ri.tr_start[-1] + ri.tr_len[-1]) if ri.tr_len.size else 0
            )
            self.dev_tr_start = put(
                np.append(ri.tr_start, [total, total]), np.int32
            )
        else:
            self.dev = DeviceSegment.from_sealed(
                segment, device=self.device, impact_dtype=impact_dtype
            )
            self._ranges = None

    @classmethod
    def from_reference(
        cls, ref, device="cuda", deleted: Optional[np.ndarray] = None, **options
    ) -> "ExactEngine":
        """Port engine over a copy of a reference ExactEngine's state, or
        over a sealed segment of either package (then ``options`` are the
        constructor's).  The segment crosses by value; a reference engine
        built with ``share=`` comes back as a standalone compact engine."""
        if not hasattr(ref, "segment"):  # a sealed segment
            engine = cls(segment_from_reference(ref), device=device, **options)
        else:
            if ref.compact:
                impact = ref.dev_post_impact
            else:
                impact = ref.dev.post_impact
            bf16 = "bfloat16" in str(impact.dtype)
            engine = cls(
                segment_from_reference(ref.segment),
                device=device,
                accumulator_budget=ref.accumulator_budget,
                impact_dtype="bfloat16" if bf16 else "float32",
                compact=ref.compact,
                strategy=ref.strategy,
            )
            if deleted is None:
                live = np.asarray(ref.dev.doc_live)[: ref.segment.n_docs]
                deleted = live == 0
        if deleted is not None:
            engine.set_deleted(deleted)
        return engine

    def set_deleted(self, deleted: np.ndarray) -> None:
        self.dev.set_deleted(deleted)

    def memory_report(self) -> dict:
        """Device-resident index bytes (the equal-index-memory metric)."""
        doc_tables = 4 * (self.segment.n_docs + 1)  # doc_live f32
        if self.compact:
            ri = self._ranges
            m1 = ri.tr_range.size + 1
            range_meta = (4 + 4) * m1 + 4  # tr_range + tr_start(+total)
            imp = self.dev_post_impact
            postings = imp.numel() * imp.element_size() + ri.post_local.nbytes
            total = postings + range_meta + doc_tables
            n_post = max(1, ri.post_local.size - ri.range_size)
            return {
                "postings": postings,
                "range_meta": range_meta,
                "doc_tables": doc_tables,
                "total": total,
                "bytes_per_posting": (postings + range_meta) / n_post,
            }
        pd, pi = self.dev.post_docid, self.dev.post_impact
        postings = pd.numel() * pd.element_size() + pi.numel() * pi.element_size()
        total = postings + doc_tables
        n_post = max(1, int(self.segment.block_n.sum()))
        return {
            "postings": postings,
            "doc_tables": doc_tables,
            "total": total,
            "bytes_per_posting": postings / n_post,
        }

    def _grp_lists(self, ids: np.ndarray, qidx: np.ndarray, qn: int):
        """Batch-vectorized per-query (term, range) group ids (CSR slices
        of the range index, the compact analog of block lists) of a
        looked-up batch of ``qn`` queries.

        Returns (grps, starts, sizes, ords): flat group ids grouped by query
        (query q owns [starts[q], starts[q+1])) and, one more array than
        the reference returns, each group's term ordinal inside its query
        (derived from ``cnt`` with ``np.repeat``): E3 adds one ordinal at a
        time to keep the reference's sum order."""
        tts = self._ranges.token_tr_start
        empty = np.zeros(0, dtype=np.int64)
        if ids.size == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            return empty, np.zeros(qn + 1, dtype=np.int64), sizes, empty
        los = tts[ids].astype(np.int64)
        cnt = tts[ids + 1].astype(np.int64) - los
        total = int(cnt.sum())
        if total == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            return empty, np.zeros(qn + 1, dtype=np.int64), sizes, empty
        grps = np.repeat(los, cnt) + group_positions(cnt)
        q_of = np.repeat(qidx, cnt)
        ords = np.repeat(group_positions(np.bincount(qidx, minlength=qn)), cnt)
        sizes = np.bincount(q_of, minlength=qn).astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(sizes)))
        return grps, starts, sizes, ords

    def _assemble_compact(self, lists, sub: np.ndarray):
        """Pad the subset `sub`'s group lists to bucketed [q, G] matrices
        (vectorized): the group ids (pad = M) and their term ordinals
        (pad = -1)."""
        grps, starts, sizes, ords = lists
        ri = self._ranges
        m_pad = ri.tr_range.size  # the appended pad slot
        sub = np.asarray(sub, dtype=np.int64)
        sub_sizes = sizes[sub]
        q = sub.size
        g_max = _bucket(int(sub_sizes.max(initial=1)) or 1, 8)
        grp_ids = np.full((q, g_max), m_pad, dtype=np.int32)
        grp_ord = np.full((q, g_max), -1, dtype=np.int32)
        total = int(sub_sizes.sum())
        if total:
            pos = group_positions(sub_sizes)
            src = np.repeat(starts[sub], sub_sizes) + pos
            dst_q = np.repeat(np.arange(q, dtype=np.int64), sub_sizes)
            grp_ids[dst_q, pos] = grps[src]
            grp_ord[dst_q, pos] = ords[src]
        return grp_ids, grp_ord

    def _prepare_compact(self, ids: np.ndarray, qidx: np.ndarray, qn: int):
        """Host-side batch assembly (single bucket) of a looked-up batch:
        padded per-query group-id lists and their term ordinals."""
        return self._assemble_compact(
            self._grp_lists(ids, qidx, qn), np.arange(qn)
        )

    #: "auto" strategy switches to the sparse sort path at this corpus
    #: size: the stream engine's crossover (the reference's, copied for
    #: parity; to be measured again on the card, ROADMAP.md "Open
    #: metrics").
    SPARSE_MIN_DOCS = StreamEngine.SPARSE_MIN_DOCS

    def _win_lists(self, ids: np.ndarray, qidx: np.ndarray, qn: int):
        """Batch-vectorized window computation of a looked-up batch of
        ``qn`` queries: a repeat/cumsum CSR expansion of every term span
        into 128-lane row windows — no per-query Python.

        Returns ((rows, lo, hi, starts, sizes, ords), n_terms): flat window
        arrays grouped by query (query q owns [starts[q], starts[q+1])),
        per-query window counts, and per-query matched-term counts.  ``ords``
        is one more array than the reference returns: each window's term
        ordinal inside its query (derived from ``cnt`` with ``np.repeat``);
        E1 adds one ordinal at a time to keep the reference's sum order.
        """
        csr = self.dev.token_flat_start
        empty = np.zeros(0, dtype=np.int64)
        if ids.size == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            starts = np.zeros(qn + 1, dtype=np.int64)
            return (empty, empty, empty, starts, sizes, empty), np.zeros(
                qn, dtype=np.int64
            )
        n_terms = np.bincount(qidx, minlength=qn).astype(np.int64)

        s = csr[ids].astype(np.int64)
        e = csr[ids + 1].astype(np.int64)
        nz = e > s
        s, e, qidx = s[nz], e[nz], qidx[nz]
        r0 = s // BLOCK
        cnt = (e - 1) // BLOCK - r0 + 1
        total = int(cnt.sum())
        if total == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            starts = np.zeros(qn + 1, dtype=np.int64)
            return (empty, empty, empty, starts, sizes, empty), n_terms
        rows = np.repeat(r0, cnt) + group_positions(cnt)
        lo = np.maximum(np.repeat(s, cnt) - rows * BLOCK, 0)
        hi = np.minimum(np.repeat(e, cnt) - rows * BLOCK, BLOCK)
        q_of = np.repeat(qidx, cnt)  # ascending: queries stay grouped
        ords = np.repeat(group_positions(np.bincount(qidx, minlength=qn)), cnt)
        sizes = np.bincount(q_of, minlength=qn).astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(sizes)))
        return (rows, lo, hi, starts, sizes, ords), n_terms

    def _assemble_windows(self, wins, sub: np.ndarray):
        """Pad the subset `sub`'s windows to bucketed [q, P] matrices
        (vectorized scatter into the padded layout): rows, lanes and the
        windows' term ordinals (pad = -1)."""
        rows, lo, hi, starts, sizes, ords = wins
        sub = np.asarray(sub, dtype=np.int64)
        sub_sizes = sizes[sub]
        q = sub.size
        p_max = _bucket(int(sub_sizes.max(initial=1)) or 1, 8)
        win_row = np.full((q, p_max), self.dev.n_rows, dtype=np.int32)
        win_lo = np.zeros((q, p_max), dtype=np.int32)
        win_hi = np.zeros((q, p_max), dtype=np.int32)
        win_ord = np.full((q, p_max), -1, dtype=np.int32)
        total = int(sub_sizes.sum())
        if total:
            pos = group_positions(sub_sizes)
            src = np.repeat(starts[sub], sub_sizes) + pos
            dst_q = np.repeat(np.arange(q, dtype=np.int64), sub_sizes)
            win_row[dst_q, pos] = rows[src]
            win_lo[dst_q, pos] = lo[src]
            win_hi[dst_q, pos] = hi[src]
            win_ord[dst_q, pos] = ords[src]
        return win_row, win_lo, win_hi, win_ord

    def _prepare(
        self, ids: np.ndarray, qidx: np.ndarray, qn: int, with_terms: bool = False
    ):
        """Host-side batch assembly (single bucket) of a looked-up batch:
        padded per-query posting-row windows and their term ordinals.

        with_terms=True additionally returns the max matched-term count
        in the batch (bounds the sparse path's segment lengths)."""
        wins, n_terms = self._win_lists(ids, qidx, qn)
        out = self._assemble_windows(wins, np.arange(qn))
        if with_terms:
            return (*out, int(max(1, n_terms.max(initial=1))))
        return out

    def search_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """``search_ids_async`` on the batch looked up in this engine's
        token table."""
        queries = list(queries)
        ids, qidx = batch_lookup(self.segment.lookup_tokens, queries)
        return self.search_ids_async(ids, qidx, len(queries), k, filter_mask)

    def search_ids_async(
        self,
        ids: np.ndarray,
        qidx: np.ndarray,
        qn: int,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Dispatch a batch of ``qn`` queries looked up in this engine's
        token table (``ids``, ``qidx`` as ``batch_lookup`` gives them) and
        return finalize() -> (scores, ids, payloads).

        The kernels are enqueued on the current stream and return
        immediately; deferring the host sync to finalize() lets callers
        pipeline many batches — host prep of batch i+1 overlaps device
        compute and result transfer of batch i.

        Queries are dispatched in COST BUCKETS (powers of 4 over their
        posting-window count) so padding is per bucket: on Zipf corpora
        the p99/p50 window-count ratio is ~20x, and one heavy-tail query
        must not inflate every query's gather/sort width.  Dense
        dispatches are additionally capped so the [q, N] accumulator
        stays under `accumulator_budget`.
        """
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        dev = self.dev
        device = self.device
        use_sparse = not self.compact and (
            self.strategy == "sparse"
            or (
                self.strategy == "auto"
                and dev.n_docs >= self.SPARSE_MIN_DOCS
            )
        )

        fm = np.ones(dev.n_docs + 1, dtype=np.float32)
        if filter_mask is not None:
            fm[: dev.n_docs] = np.asarray(filter_mask, dtype=np.float32)
        fm_dev = torch.from_numpy(fm).to(device)

        kk = min(_bucket(k, 1), max(dev.n_docs, 1))

        n_terms = np.ones(qn, dtype=np.int64)
        if self.compact:
            lists = self._grp_lists(ids, qidx, qn)
            sizes = lists[2]
        else:
            lists, n_terms = self._win_lists(ids, qidx, qn)
            sizes = lists[4]

        # Bucket only when padding waste is material: splitting costs a
        # fixed dispatch overhead per bucket, worth paying only when
        # batch-max padding would gather far more dead lanes than that
        # (65536 windows ~ 64 MB of wasted gather traffic).
        bucket_of = np.zeros(qn, dtype=np.int64)
        waste = qn * int(sizes.max(initial=0)) - int(sizes.sum())
        if waste > 65536:
            b = 32
            while np.any(sizes > b):
                bucket_of[sizes > b] += 1
                b *= 4

        # The sparse path allocates no [q, N] accumulator; no cap needed.
        if use_sparse and not self.compact:
            q_cap = 1 << 30
        else:
            q_cap = max(1, self.accumulator_budget // (4 * (dev.n_docs + 1)))

        def put(x):
            return torch.from_numpy(x).to(device)

        pending = []
        for bu in np.unique(bucket_of):
            bidx = np.flatnonzero(bucket_of == bu)
            # Besides the accumulator budget, cap each dispatch's gather
            # volume (q * P * 128 lanes): one dispatch materializes
            # ~8-24 B per lane, and very large batches of heavy queries
            # otherwise spike transient device memory by gigabytes.
            p_bucket = max(1, _bucket(int(sizes[bidx].max(initial=1)), 8))
            lane_cap = max(1, (1 << 26) // (p_bucket * 128))
            step = max(1, min(q_cap, lane_cap))
            for i0 in range(0, bidx.size, step):
                sub = bidx[i0 : i0 + step]
                if self.compact:
                    grp_ids, grp_ord = self._assemble_compact(lists, sub)
                    out = _score_and_topk_compact(
                        self.dev_post_impact,
                        self.dev_post_local,
                        self.dev_tr_range,
                        self.dev_tr_start,
                        dev.doc_live,
                        fm_dev,
                        put(grp_ids),
                        put(grp_ord),
                        int(grp_ord.max(initial=-1)) + 1,
                        k=kk,
                        n_docs=dev.n_docs,
                        range_size=self._ranges.range_size,
                    )
                elif use_sparse:
                    wr, wl, wh, wo = self._assemble_windows(lists, sub)
                    mt = int(max(1, n_terms[sub].max(initial=1)))
                    out = exact_sparse_topk(
                        dev.post_docid,
                        dev.post_impact,
                        dev.doc_live,
                        fm_dev,
                        put(wr),
                        put(wl),
                        put(wh),
                        k=kk,
                        n_docs=dev.n_docs,
                        seg_steps=int(mt - 1).bit_length(),
                        seg_off=torch.from_numpy(ordinal_offsets(wo)),
                    )
                else:
                    wr, wl, wh, wo = self._assemble_windows(lists, sub)
                    out = _score_and_topk(
                        dev.post_docid,
                        dev.post_impact,
                        dev.doc_live,
                        put(wr),
                        put(wl),
                        put(wh),
                        put(wo),
                        int(wo.max(initial=-1)) + 1,
                        None if filter_mask is None else fm_dev,
                        k=kk,
                        n_docs=dev.n_docs,
                    )
                pending.append((sub, out))

        payload_arr = np.asarray(dev.host.doc_payload)

        def finalize():
            scores = np.full((qn, k), -np.inf, dtype=np.float32)
            ids = np.full((qn, k), -1, dtype=np.int64)
            payloads = np.full((qn, k), -1, dtype=np.int64)
            for sub, (s_dev, i_dev) in pending:
                s = s_dev.cpu().numpy()[:, :k]
                i = i_dev.cpu().numpy().astype(np.int64)[:, :k]
                if s.shape[1] < k:
                    # Fewer doc slots than k: pad to the [q, k] contract.
                    pad = k - s.shape[1]
                    s = np.pad(
                        s, ((0, 0), (0, pad)), constant_values=-np.inf
                    )
                    i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
                valid = np.isfinite(s)
                i = np.where(valid, i, -1)
                p = np.where(valid, payload_arr[np.maximum(i, 0)], -1)
                scores[sub], ids[sub], payloads[sub] = s, i, p
            return scores, ids, payloads

        return finalize

    def search(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k for a batch of queries.

        Returns (scores [Q,k] f32, doc_slots [Q,k] i64, payloads [Q,k] i64);
        slots past the number of matching docs have score -inf, slot/payload -1.
        filter_mask: optional [n_docs] bool — True keeps the doc (prefilter
        semantics: applied before top-k so the threshold stays honest).
        """
        return self.search_async(queries, k, filter_mask)()


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
