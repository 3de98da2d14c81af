"""Exact batched search over the compressed posting stream
(counterpart of ``search/stream.py``): the dense, sparse and MaxScore
strategies and ``auto``'s routing between them.

The served default: ``Bm25Index`` builds this engine unless told
otherwise.  ``strategy="auto"`` takes the dense reduction below
``SPARSE_MIN_DOCS`` (2^21) docs; from there on it routes each query, as
the reference does, to MaxScore (k <= 128 and the router predicts enough
pruning) or to the exhaustive sparse reduction, which also takes every
query MaxScore cannot certify.  The reductions, per dispatch:

- dense: ``ops/stream_kernel.py`` (S1) decodes, scores and adds every
  window into a ``[n_q, N+1]`` accumulator, one term ordinal at a time so
  the adds land in the reference's order; ``ops/topk.py`` (S2) takes the
  exact hierarchical top-k of each row;
- sparse: ``ops/stream_sparse.py`` decodes every lane of a ``[q, P]``
  window matrix (S3), sorts each row by doc and sums each doc's run into
  packed selection keys (S4), then selects the top k;
- MaxScore: the reference's tiers, each a sparse pass over the
  impact-ordered window prefix into a candidate pool, then
  ``ops/stream_rescore.py`` (S5) rescores the candidates exactly.

The numpy planning (``_layout``, ``_assemble``, ``_ms_route``,
``_maxscore_phase``, ``_maxscore_tables``, ``_s1_by_doc_host``, and the
helpers ``_ms_prefix_prep`` and ``_ms_certify``), ``set_deleted``,
``memory_report`` and ``search`` are copies of the reference's, running on
the torch tensors uploaded here; the methods that reach jax there are
rewritten.  A batch is planned from its lookup in the segment's token
table, ``(ids, qidx)`` as ``utils/batchkeys.py::batch_lookup`` gives it:
``search_ids_async`` serves that form (the facade looks a batch up once
and hands it here), ``search_async`` looks ``Query`` objects up and calls
it.  The reference's ``_throttle_large`` (a jax-only guard against a
TPU dispatch pile-up) has no counterpart: each dispatch's lanes or
accumulator are freed before the next is allocated, and only the
``[q, k]`` results wait for ``finalize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..index.sealed import SealedSegment
from ..index.stream import _DELETED_BIT, StreamIndex, build_stream_index
from ..ops.stream_kernel import stream_dense_accumulate
from ..ops.stream_rescore import rescore_topk
from ..ops.stream_sparse import doc_ordered, segment_offsets, stream_sparse_topk
from ..ops.topk import dense_topk
from ..text.intern import Query
from ..utils.batchkeys import batch_lookup, group_positions, select_rows
from ..utils import tracing
from ..utils.buckets import bucket_pow2 as _bucket
from ..utils.device import as_device

__all__ = ["StreamEngine", "routes_maxscore", "window_ordinals"]

# Lanes a sparse dispatch may hold (the reference's cap, search/stream.py
# :797, :882, :1081): 512 MB of (doc, score) before the sort's copy.
_LANE_CAP = 1 << 26


def _ms_prefix_prep(
    order, bounds, tws, ids, qidx, qn, tau_frac, exclude_frac
):
    """Host-side MaxScore phase-1 prefix selection (shared by the
    single-chip engine and the sharded mesh path).

    order/bounds: impact-descending window permutation per term and its
    (f64) bounds; tws: token -> window-span starts; ids/qidx: matched
    term ids and their query index; qn: query count.

    Returns (lo, hi, cut, s_rem, excl): per-term window spans into the
    impact-ordered table, the per-term prefix length (windows with
    bound >= tau_frac * query-max-bound, zeroed for excluded terms),
    the per-query certification remainder S = Σ next-window bounds,
    and the excluded-term mask.
    """
    lo = tws[ids].astype(np.int64)
    hi = tws[ids + 1].astype(np.int64)

    maxb = np.zeros(qn, dtype=np.float64)
    np.maximum.at(maxb, qidx, bounds[lo])
    tau = (maxb * tau_frac)[qidx]
    # Count of (descending) bounds >= tau in each [lo, hi) span.
    l, r = lo.copy(), hi.copy()
    for _ in range(int(np.max(hi - lo, initial=1)).bit_length() + 1):
        m = (l + r) >> 1
        go = (m < r) & (bounds[np.minimum(m, bounds.size - 1)] >= tau)
        l = np.where(go, m + 1, l)
        r = np.where(go, r, m)
    cut = l - lo
    # Term-level exclusion (the MaxScore essential-set rule): window
    # maxima within a common term are nearly flat on Zipf corpora, so
    # the tau prefix is all-or-nothing there — the only lever that
    # skips a common term's (huge) posting span in phase 1 is dropping
    # the WHOLE term.  Per query, exclude terms ascending by term bound
    # while the inclusive excluded mass stays under
    # exclude_frac * maxb; certification keeps the result exact and
    # excluded terms still contribute exactly in the candidate rescore
    # (search.rs:151-280's skip machinery actually skipping the
    # common-term lists).
    excl = np.zeros(qidx.size, dtype=bool)
    if exclude_frac > 0.0:
        tb = bounds[lo]
        t_order = np.lexsort((tb, qidx))
        tb_s = tb[t_order]
        q_s = qidx[t_order]
        cg = np.concatenate(([0.0], np.cumsum(tb_s)))
        qstart_s = np.concatenate(
            ([0], np.cumsum(np.bincount(q_s, minlength=qn)))
        )
        incl = cg[1:] - cg[qstart_s[q_s]]
        excl[t_order] = incl < exclude_frac * maxb[q_s]
        cut = np.where(excl, 0, cut)
    rem = np.where(
        cut < hi - lo,
        bounds[np.minimum(lo + cut, bounds.size - 1)],
        0.0,
    )
    s_rem = np.zeros(qn, dtype=np.float64)
    np.add.at(s_rem, qidx, rem)
    return lo, hi, cut, s_rem, excl


def _ms_certify(kth_exact, last, s_rem):
    """Exact-theta certification (shared single-chip / sharded): the k
    rescored docs exist with these exact scores, so kth_exact is a
    valid lower bound on the true kth score.  A doc never seen in
    phase 1 scores at most s_rem; a doc that fell out of the phase-1
    pool scores at most last + s_rem.  A few f32 ulps of slack keep
    the comparison conservative.  Returns (fail_unseen, fail_pool)."""
    eps = 4.0 * np.spacing(
        np.abs(kth_exact).astype(np.float32)
    ).astype(np.float64)
    fail_unseen = ~np.isfinite(kth_exact) | (s_rem >= kth_exact - eps)
    fail_pool = np.isfinite(last) & (last + s_rem >= kth_exact - eps)
    return fail_unseen, fail_pool



def routes_maxscore(strategy: str, n_docs: int, k: int) -> bool:
    """Whether a batch at ``k`` goes to MaxScore, wholly or by the router
    (``StreamEngine._ms_route``): 'maxscore' sends every query through the
    pruned path (k above ``MS_MAX_K`` serves exhaustively); from
    ``SPARSE_MIN_DOCS`` docs on, 'auto' routes per query (k <=
    ``MS_ROUTE_MAX_K``), all three ``StreamEngine``'s.  The single engine
    and the sharded index (``n_docs``: its largest shard) both gate on
    it."""
    if k > StreamEngine.MS_MAX_K:
        return False
    return strategy == "maxscore" or (
        strategy == "auto"
        and n_docs >= StreamEngine.SPARSE_MIN_DOCS
        and k <= StreamEngine.MS_ROUTE_MAX_K
    )


def window_ordinals(stream: StreamIndex, wsrc, starts, sizes) -> np.ndarray:
    """Each window's term ordinal inside its query, from ``_layout``'s
    lists: a query's windows are term-major, and a new term entry starts
    where the window ids stop being consecutive or the token changes (a
    term repeated in a query restarts its span, so it counts twice)."""
    t = wsrc.size
    if t == 0:
        return np.zeros(0, dtype=np.int64)
    new = np.zeros(t, dtype=bool)
    new[starts[:-1][sizes > 0]] = True
    tok = stream.w_token[wsrc]
    new[1:] |= (wsrc[1:] != wsrc[:-1] + 1) | (tok[1:] != tok[:-1])
    entry = np.cumsum(new) - 1
    first = np.repeat(starts[:-1], sizes)
    return entry - entry[first]


class StreamEngine:
    """Batched exact search from the compressed stream, on torch.

    Every strategy of the reference (``"auto"``, ``"dense"``, ``"sparse"``,
    ``"maxscore"``); on a CUDA device every dispatch runs the CUDA kernels
    S1-S5, on the CPU their plain PyTorch versions."""

    #: "auto" strategy switches to the sparse sort path at this corpus
    #: size (the reference's measured crossover, DESIGN.md; ExactEngine
    #: takes the same value).
    SPARSE_MIN_DOCS = 1 << 21

    def __init__(
        self,
        segment: SealedSegment,
        stream: Optional[StreamIndex] = None,
        device="cuda",
        accumulator_budget: int = 1 << 30,
        strategy: str = "auto",
        global_stats=None,
        ms_exclude: float = 0.5,
    ):
        # The reference's __init__ (search/stream.py:445-502) with torch
        # uploads in place of jax.device_put.
        if strategy not in ("auto", "dense", "sparse", "maxscore"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if not 0.0 <= ms_exclude < 1.0:
            raise ValueError("ms_exclude must be in [0, 1)")
        self.device = as_device(device)
        self.strategy = strategy
        self.ms_exclude = float(ms_exclude)
        self._ms = None
        self.last_ms_stats = None
        self.segment = segment
        self.accumulator_budget = accumulator_budget
        self.stream = stream or build_stream_index(
            segment, global_stats=global_stats
        )
        si = self.stream

        def put(x, dtype=None):
            arr = np.ascontiguousarray(x, dtype=dtype)
            return torch.from_numpy(arr).to(self.device)

        with tracing.span("vcbm25.build.upload"):
            # u32 words and u16 meta as the same bits in int32 / int16 (every
            # meta value is below 2^15): torch's unsigned coverage is thin.
            self.dev_words = put(si.words.view(np.int32))
            self._doc_fn_host = si.doc_fn.copy()
            self.dev_s1bd = put(self._s1_by_doc_host())
            self._pad_off = np.int32(si.words.size - 64)
            self._pad_win = np.int32(si.n_windows)
            self.dev_w_off = put(np.append(si.w_off4, self._pad_off), np.int32)
            self.dev_w_base = put(np.append(si.w_base, 0), np.int32)
            self.dev_w_meta = put(
                np.append(si.w_meta16(), 0).astype(np.uint16).view(np.int16)
            )
            self.dev_w_s0 = put(np.append(si.w_s0, 0.0), np.float32)
        self.n_docs = si.n_docs

    def _s1_by_doc_host(self) -> np.ndarray:
        """[N+1] float32 s1[fieldnorm[d]] with +inf at deleted docs and
        the pad slot (doc_fn bit 8 = deleted, index/stream.py)."""
        fn = self._doc_fn_host
        return np.where(
            fn < 256,
            self.stream.s1_table[fn & 0xFF],
            np.inf,
        ).astype(np.float32)

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Set/clear the deleted bit in the fieldnorm table (the
        scoring-time bitmap; the reference flips DocumentTuple.deleted,
        bulkdelete.rs:79-111)."""
        n = self.n_docs
        fn = self.stream.doc_fn.copy()
        d = np.asarray(deleted, dtype=bool)[:n]
        fn[:n] = np.where(d, fn[:n] | _DELETED_BIT, fn[:n] & 0xFF)
        self._doc_fn_host = fn
        self.dev_s1bd = _upload(self._s1_by_doc_host(), self.device)

    def _s1_eff(self, filter_mask: Optional[np.ndarray]):
        """dev_s1bd with filtered docs (filter value <= 0) forced to +inf."""
        if filter_mask is None:
            return self.dev_s1bd
        fm = np.ones(self.n_docs + 1, dtype=np.float32)
        fm[: self.n_docs] = np.asarray(filter_mask, dtype=np.float32)
        keep = _upload(fm, self.device) > 0.0
        return torch.where(keep, self.dev_s1bd, float("inf"))

    def memory_report(self) -> dict:
        """Device-resident index bytes (equal-index-memory metric)."""
        db = self.stream.device_bytes()
        wmeta = sum(
            int(t.nbytes)
            for t in (
                self.dev_w_off,
                self.dev_w_base,
                self.dev_w_meta,
                self.dev_w_s0,
            )
        )
        # The engine serves from the fused [N+1] f32 s1-by-doc table
        # (4 B/doc) instead of the u16 fieldnorm + 1 KB s1 table.
        doc_tables = int(self.dev_s1bd.nbytes)
        total = db["postings"] + doc_tables + wmeta
        return {
            "postings": db["postings"],
            "doc_tables": doc_tables,
            "s1_table": 0,
            # 14 B per window: the reference's SummaryTuple costs 24 B
            # per 128-posting block (tuples.rs:900-971) and is counted
            # on its side of the parity report too.
            "window_meta": wmeta,
            "total": total,
            "bytes_per_posting": (db["postings"] + wmeta)
            / max(1, self.stream.n_postings),
        }

    @tracing.traced("vcbm25.stream.lookup")
    def _layout(self, ids: np.ndarray, qidx: np.ndarray, qn: int):
        """The window layout of a looked-up batch of ``qn`` queries:
        (lists, n_terms, (cnt, qidx)).  ``lists`` = (wsrc, starts, sizes),
        the vectorized per-query window-id lists (CSR slices of the
        stream's window table); ``n_terms``, each query's matched-term
        count; (cnt, qidx), the sparse kernels' segments: each (query, term
        occurrence)'s window count and query, in the lists' order."""
        tws = self.stream.token_w_start
        empty = np.zeros(0, dtype=np.int64)
        if ids.size == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            lists = (empty, np.zeros(qn + 1, dtype=np.int64), sizes)
            return lists, np.zeros(qn, dtype=np.int64), (empty, empty)
        n_terms = np.bincount(qidx, minlength=qn).astype(np.int64)
        los = tws[ids]
        cnt = tws[ids + 1] - los
        total = int(cnt.sum())
        if total == 0:
            sizes = np.zeros(qn, dtype=np.int64)
            return (empty, np.zeros(qn + 1, dtype=np.int64), sizes), n_terms, (cnt, qidx)
        wsrc = np.repeat(los, cnt) + group_positions(cnt)
        q_of = np.repeat(qidx, cnt)
        sizes = np.bincount(q_of, minlength=qn).astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(sizes)))
        return (wsrc, starts, sizes), n_terms, (cnt, qidx)

    def _assemble(self, lists, sub: np.ndarray):
        """Pad the subset's window-id lists to a bucketed [q, P] matrix
        (sparse path; metadata is gathered device-side)."""
        wsrc, starts, sizes = lists
        sub = np.asarray(sub, dtype=np.int64)
        sub_sizes = sizes[sub]
        q = sub.size
        p_max = _bucket(int(sub_sizes.max(initial=1)) or 1, 8)
        ids = np.full((q, p_max), self._pad_win, dtype=np.int32)
        total = int(sub_sizes.sum())
        src = None
        if total:
            pos = group_positions(sub_sizes)
            src = wsrc[np.repeat(starts[sub], sub_sizes) + pos]
            dst_q = np.repeat(np.arange(q, dtype=np.int64), sub_sizes)
            ids[dst_q, pos] = src
        return ids, src

    def _maxscore_tables(self):
        """Impact-descending window order within each term + its bounds
        (f64, conservatively padded at build) — the MaxScore analog of
        the reference's per-term wand pair ordering (TokenTuple)."""
        if self._ms is None:
            si = self.stream
            order = np.lexsort((-si.w_maximp, si.w_token)).astype(
                np.int64
            )
            self._ms = (order, si.w_maximp[order].astype(np.float64))
        return self._ms

    #: Certification tiers for strategy='maxscore': (tau_frac,
    #: pool_min, exclude_override).  Tier 1 is the cheap pass; queries
    #: it cannot certify retry on tier 2 with a lower impact threshold
    #: (smaller s_rem) and a deeper partial pool (smaller pool-
    #: truncation bound) before the exhaustive fallback — still far
    #: cheaper than scoring every posting for the retried queries.
    MS_TIERS = ((0.5, 512, None), (0.25, 2048, 0.0))
    #: Per-query routing thresholds for strategy='auto' at scale.  A
    #: query goes to the pruned path only when the tier-1 bound
    #: structure predicts enough skippable work to beat the exhaustive
    #: sparse scan: measured at 8.4M docs (artifacts/
    #: bench_8m_{sparse,maxscore}_r04.json), 4-term similar-idf
    #: informative queries keep 70% of their windows through the
    #: phase-1 prefix and the pruned path runs 2.4x SLOWER than
    #: exhaustive-sparse — pruning must be predicted profitable per
    #: query, never assumed from corpus size.
    MS_ROUTE_FRAC = 0.35
    MS_ROUTE_MIN_WINDOWS = 256
    #: 'auto' routes to the pruned path only at k <= this.  The pruned
    #: path's cost grows with k (certification needs the kth EXACT
    #: score, so pools sort ~16x more entries at k=1000) while its
    #: traction shrinks (a deep kth score is a low threshold the
    #: bounds rarely clear): measured at 8.4M docs, k=1000, routing
    #: LOSES 2.3x on the informative mix (29.15 QPS routed vs 66.56
    #: exhaustive, artifacts/bench_8m_{auto,sparse}_k1000_r05.json)
    #: and is at best break-even on the heavy mix (3.08 vs ~3.3),
    #: while at k=10 it WINS both mixes (DESIGN.md round-5 table).
    #: 128 covers the top-10/top-100 serving regime the win is
    #: measured in; explicit strategy='maxscore' still serves any
    #: k <= MS_MAX_K pruned.
    MS_ROUTE_MAX_K = 128
    #: Deepest k the pruned path serves (the reference's WAND serves
    #: any LIMIT, gucs.rs caps bm25.limit at 65535; the partial pool
    #: here must hold ~16k candidates, so k=1000 north-star retrieval
    #: fits with the 16384-entry pool and anything deeper serves
    #: exhaustively).  VERDICT r3 #5.
    MS_MAX_K = 1024
    #: Partial-pool ceiling (entries per query per tier).
    MS_POOL_CAP = 16384

    @tracing.traced("vcbm25.stream.route")
    def _ms_route(self, ids, qidx, qn):
        """Predicted-work router for strategy='auto' at scale: True for
        queries the pruned path should serve.

        Cost model: the pruned path pays ~frac x the exhaustive window
        scan plus fixed rescore/pool overhead, so it wins only when the
        tier-1 prefix keeps a small fraction of a LARGE window set —
        i.e. the query carries common terms whose flat low bounds the
        exclusion rule can drop (the case the reference's WAND skip
        machinery targets, search.rs:151-280).  Selective queries
        (small window sets) and flat-impact informative queries route
        to the exhaustive sparse scan, which is already near the HBM
        roofline for them."""
        if ids.size == 0:
            return np.zeros(qn, dtype=bool)
        order, bounds = self._maxscore_tables()
        tws = self.stream.token_w_start
        tau_frac, _, excl_over = self.MS_TIERS[0]
        lo, hi, cut, _, _ = _ms_prefix_prep(
            order, bounds, tws, ids, qidx, qn, tau_frac,
            self.ms_exclude if excl_over is None else excl_over,
        )
        tot = np.bincount(
            qidx, weights=(hi - lo).astype(np.float64), minlength=qn
        )
        ph1 = np.bincount(
            qidx, weights=cut.astype(np.float64), minlength=qn
        )
        frac = np.where(tot > 0, ph1 / np.maximum(tot, 1.0), 1.0)
        return (tot >= self.MS_ROUTE_MIN_WINDOWS) & (
            frac <= self.MS_ROUTE_FRAC
        )

    @tracing.traced("vcbm25.stream.maxscore")
    def _maxscore_phase(self, ids, qidx, qn, k, s1_eff, n_terms):
        """Tiered two-phase pruned exact top-k (strategy='maxscore').

        Each tier scores only each term's highest-bound windows
        (bound >= tau_frac * max-bound); any doc outside that prefix
        can add at most S = Σ-per-term next-window bounds, so after the
        exact rescore of the surviving candidates, the kth exact score
        certifies the result (see _ms_tier).  Queries a tier cannot
        certify retry on the next (lower tau, deeper pool); queries no
        tier certifies are returned for the exhaustive fallback.

        Returns (pending entries for finalize, fallback query indices).
        """
        if ids.size == 0:
            return [], np.zeros(0, dtype=np.int64)
        pending = []
        active = np.arange(qn, dtype=np.int64)
        tiers = []
        for tau_frac, pool_min, excl_over in self.MS_TIERS:
            t_ids, t_qidx = select_rows(ids, qidx, qn, active)
            t_n = n_terms[active]
            tier_pending, tier_fb, tstats = self._ms_tier(
                t_ids, t_qidx, active.size, k, s1_eff, t_n,
                tau_frac, pool_min,
                self.ms_exclude if excl_over is None else excl_over,
            )
            for qs_local, data in tier_pending:
                pending.append((active[qs_local], data))
            tiers.append(tstats)
            active = active[tier_fb]
            if active.size == 0:
                break
        self.last_ms_stats = {
            "queries": qn,
            "tiers": tiers,
            "fallback_queries": int(active.size),
        }
        return pending, active

    def _window_tables(self):
        return (self.dev_w_off, self.dev_w_base, self.dev_w_meta, self.dev_w_s0)

    def _sparse_topk(self, s1_eff, lists, segs, sub, k: int, max_terms: int):
        """One sparse dispatch (the reference's ``_stream_sparse`` call) over
        the queries ``sub`` of ``lists``, which match at most ``max_terms``
        terms, repeats counted: their ``[q, P]`` window matrix and their
        segments, from ``segs`` (each term occurrence's window count and
        query)."""
        mat, _ = self._assemble(lists, sub)
        seg_off = segment_offsets(*segs, sub, lists[2].size)
        mat = _upload(mat, self.device)
        with tracing.span("vcbm25.stream.launch"):
            return stream_sparse_topk(
                self.dev_words, s1_eff, *self._window_tables(),
                mat, k, self.n_docs,
                int(max_terms - 1).bit_length(), torch.from_numpy(seg_off),
            )

    def _dispatches(self, lists):
        """The reference's dense chunking (search/stream.py:1016-1047) of
        ``_layout``'s lists: yields (query rows, wsrc [tb] int32, q_start
        [n_qb + 1] int32, w_ord [tb] int32, n_qb) per dispatch: windows in
        the reference's order with pad windows (len 0, ordinal -1, outside
        every span) up to the bucketed tb, and each query's span of them
        (the bucket's extra rows own none)."""
        wsrc_all, starts, sizes = lists
        qn = sizes.size
        n_docs = self.n_docs
        ord_all = window_ordinals(self.stream, wsrc_all, starts, sizes)
        q_cap = max(1, self.accumulator_budget // (4 * (n_docs + 1)))
        while q_cap * (n_docs + 1) >= 1 << 31:  # the reference's int32 bound
            q_cap //= 2
        t_cap = 1 << 19
        q0 = 0
        while q0 < qn:
            q1 = min(qn, q0 + q_cap)
            if starts[q1] - starts[q0] > t_cap:
                q1 = int(
                    np.searchsorted(starts, starts[q0] + t_cap, side="right") - 1
                )
                q1 = max(q1, q0 + 1)
            t0, t1 = int(starts[q0]), int(starts[q1])
            t = t1 - t0
            tb = _bucket(max(t, 1), 128)
            wsrc = np.full(tb, self._pad_win, dtype=np.int32)
            wsrc[:t] = wsrc_all[t0:t1]
            n_qb = _bucket(q1 - q0, 8)
            q_start = np.full(n_qb + 1, t, dtype=np.int32)
            q_start[: q1 - q0 + 1] = starts[q0 : q1 + 1] - t0
            w_ord = np.full(tb, -1, dtype=np.int32)
            w_ord[:t] = ord_all[t0:t1]
            yield np.arange(q0, q1), wsrc, q_start, w_ord, n_qb
            q0 = q1

    @tracing.traced("vcbm25.stream.ms_tier")
    def _ms_tier(
        self, ids, qidx, qn, k, s1_eff, n_terms, tau_frac, pool_min,
        exclude_frac,
    ):
        """One MaxScore certification tier over a query subset (local
        indices 0..qn): the reference's ``_ms_tier`` (search/stream.py
        :752-926), statement for statement, with its two device calls
        replaced by ``stream_sparse_topk`` (phase 1) and ``rescore_topk``
        (phase 2).  The kernels read window widths and search depths at run
        time, so the reference's ``_active_widths`` and ``bs_steps`` go.

        Returns (pending entries in local indices, local fallback
        indices, stats dict).
        """
        si = self.stream
        n_docs = self.n_docs
        order, bounds = self._maxscore_tables()
        tws = si.token_w_start
        lo, hi, cut, s_rem, excl = _ms_prefix_prep(
            order, bounds, tws, ids, qidx, qn, tau_frac, exclude_frac
        )
        stats = {
            "queries": qn,
            "tau_frac": tau_frac,
            "windows_total": int((hi - lo).sum()),
            "windows_phase1": int(cut.sum()),
            "excluded_terms": int(excl.sum()),
            "terms": int(qidx.size),
        }

        # Phase 1: the prefix windows through the sparse reduction with a
        # C-wide result pool.  A term's prefix lists its windows by impact;
        # the sparse kernels take each segment's in doc order, which the
        # reduction does not depend on.
        wsrc = doc_ordered(order[np.repeat(lo, cut) + group_positions(cut)], cut)
        q_of = np.repeat(qidx, cut)
        sizes = np.bincount(q_of, minlength=qn).astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(sizes)))
        lists = (wsrc, starts, sizes)
        c_pool = int(min(_bucket(max(16 * k, pool_min), 1), self.MS_POOL_CAP))
        p1 = []
        p_bucket = max(1, _bucket(int(sizes.max(initial=1)), 8))
        lane_cap = max(1, _LANE_CAP // (p_bucket * 128))
        for i0 in range(0, qn, lane_cap):
            sub = np.arange(i0, min(qn, i0 + lane_cap))
            mt = int(max(1, n_terms[sub].max(initial=1)))
            p1.append((sub, self._sparse_topk(s1_eff, lists, (cut, qidx), sub, c_pool, mt)))
        sp = np.full((qn, c_pool), -np.inf, dtype=np.float32)
        ip = np.full((qn, c_pool), n_docs, dtype=np.int64)
        for sub, (s_d, i_d) in p1:
            tracing.count("dispatch_syncs")
            s = _host(s_d)
            i = _host(i_d).astype(np.int64)
            sp[sub, : s.shape[1]] = s
            ip[sub, : i.shape[1]] = np.where(np.isfinite(s), i, n_docs)
        del p1

        theta = sp[:, k - 1].astype(np.float64)
        last = sp[:, -1].astype(np.float64)
        # Queries with fewer than k finite partials cannot form a selection
        # threshold; the others are certified after the rescore, against
        # the kth exact score.
        hopeless = ~np.isfinite(theta)
        ok = np.flatnonzero(~hopeless)
        fallback = np.flatnonzero(hopeless)
        stats["fallback_queries"] = int(fallback.size)
        if ok.size == 0:
            return [], fallback, stats

        # Candidates: partial + S could reach the kth partial (a few f32
        # ulps of slack keep the set a superset under rounding).
        th = theta[ok]
        th_pad = th - 4.0 * np.spacing(
            np.abs(th).astype(np.float32)
        ).astype(np.float64)
        mask = np.isfinite(sp[ok]) & (
            sp[ok].astype(np.float64) + s_rem[ok, None] >= th_pad[:, None]
        )
        cand_ids = np.where(mask, ip[ok], n_docs)
        cand_ids.sort(axis=1)
        c_pad = int(_bucket(max(int(mask.sum(1).max(initial=1)), k), 16))
        if c_pad <= cand_ids.shape[1]:
            cand = cand_ids[:, :c_pad]
        else:
            cand = np.pad(
                cand_ids,
                ((0, 0), (0, c_pad - cand_ids.shape[1])),
                constant_values=n_docs,
            )
        cand = cand.astype(np.int32)

        # Per-(query, term) window spans in the original doc-ascending
        # order for the rescore's binary search.
        qstart = np.concatenate(
            ([0], np.cumsum(np.bincount(qidx, minlength=qn)))
        )
        tpos = np.arange(qidx.size, dtype=np.int64) - qstart[qidx]
        row = np.full(qn, -1, dtype=np.int64)
        row[ok] = np.arange(ok.size)
        selp = row[qidx] >= 0
        tmax = int(_bucket(int(n_terms[ok].max(initial=1)), 2))
        t_lo = np.zeros((ok.size, tmax), dtype=np.int32)
        t_hi = np.zeros((ok.size, tmax), dtype=np.int32)
        t_lo[row[qidx[selp]], tpos[selp]] = lo[selp]
        t_hi[row[qidx[selp]], tpos[selp]] = hi[selp]

        stats["candidate_pad"] = int(c_pad)
        res_s = np.full((ok.size, k), -np.inf, dtype=np.float32)
        res_i = np.zeros((ok.size, k), dtype=np.int64)
        lane_cap2 = max(1, _LANE_CAP // (tmax * c_pad * 128))
        for i0 in range(0, ok.size, lane_cap2):
            s2 = slice(i0, min(ok.size, i0 + lane_cap2))
            parts = [_upload(x[s2], self.device) for x in (cand, t_lo, t_hi)]
            with tracing.span("vcbm25.stream.launch"):
                s_d, i_d = rescore_topk(
                    self.dev_words, s1_eff, *self._window_tables(), *parts, k, n_docs,
                )
            tracing.count("dispatch_syncs")
            res_s[s2] = _host(s_d)[:, :k]
            res_i[s2] = _host(i_d).astype(np.int64)[:, :k]

        # Exact-theta certification (see _ms_certify): kth_exact includes
        # the excluded and tail terms' contributions; unselected pool docs
        # had partial + s_rem < theta <= kth_exact.
        kth_exact = res_s[:, k - 1].astype(np.float64)
        fail_unseen, fail_pool = _ms_certify(kth_exact, last[ok], s_rem[ok])
        stats["cert_fail_unseen"] = int(fail_unseen.sum())
        stats["cert_fail_pool"] = int((fail_pool & ~fail_unseen).sum())
        safe = ~(fail_unseen | fail_pool)
        certified = np.flatnonzero(safe)
        # Sorted: the next tier's prefix prep assumes query-ascending term
        # lists.
        fallback = np.sort(
            np.concatenate([fallback, ok[np.flatnonzero(~safe)]])
        )
        stats["fallback_queries"] = int(fallback.size)
        pending = []
        if certified.size:
            pending.append(
                (ok[certified], (res_s[certified], res_i[certified]))
            )
        return pending, fallback, stats

    def search_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Dispatch a batch and return finalize() -> (scores, ids,
        payloads): ``search_ids_async`` on the batch looked up in this
        engine's token table."""
        queries = list(queries)
        ids, qidx = batch_lookup(self.segment.lookup_tokens, queries)
        return self.search_ids_async(ids, qidx, len(queries), k, filter_mask)

    @tracing.traced("vcbm25.stream.dispatch")
    def search_ids_async(
        self,
        ids: np.ndarray,
        qidx: np.ndarray,
        qn: int,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Dispatch a batch of ``qn`` queries looked up in this engine's
        token table, ``ids`` (token ids) and ``qidx`` (their queries) as
        ``batch_lookup`` gives them, and return finalize() -> (scores, ids,
        payloads): the reference's routing (search/stream.py:939-1014),
        its dense and sparse branches (:1016-1103) and finalize
        (:1105-1127)."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        # Per-dispatch profile: cleared up front so a reader after this call
        # never sees a previous dispatch's stats.
        self.last_ms_stats = None
        n_docs = self.n_docs
        # At scale the queries MaxScore does not take (routes_maxscore,
        # _ms_route), and every query no tier certifies, take the exhaustive
        # sparse reduction.
        at_scale = n_docs >= self.SPARSE_MIN_DOCS
        ms_sel = None
        if routes_maxscore(self.strategy, n_docs, k):
            if self.strategy == "maxscore":
                ms_sel = np.arange(qn, dtype=np.int64)
            else:
                ms_sel = np.flatnonzero(self._ms_route(ids, qidx, qn))
        use_sparse = ms_sel is None and (
            self.strategy in ("sparse", "maxscore")
            or (self.strategy == "auto" and at_scale)
        )

        s1_eff = self._s1_eff(filter_mask)
        kk = min(_bucket(k, 1), max(n_docs, 1))
        lists, n_terms, segs = self._layout(ids, qidx, qn)
        sizes = lists[2]

        pending = []
        sparse_sel = np.arange(qn, dtype=np.int64)
        if ms_sel is not None:
            if ms_sel.size:
                ms_pending, fb_local = self._maxscore_phase(
                    *select_rows(ids, qidx, qn, ms_sel), ms_sel.size, k,
                    s1_eff, n_terms[ms_sel],
                )
                for qs_local, data in ms_pending:
                    pending.append((ms_sel[qs_local], data))
                not_routed = np.setdiff1d(
                    sparse_sel, ms_sel, assume_unique=True
                )
                sparse_sel = np.sort(
                    np.concatenate([not_routed, ms_sel[fb_local]])
                )
            stats = self.last_ms_stats or {
                "queries": 0,
                "tiers": [],
                "fallback_queries": 0,
            }
            stats["batch_queries"] = qn
            stats["routed_queries"] = int(ms_sel.size)
            self.last_ms_stats = stats
            use_sparse = sparse_sel.size > 0

        if not use_sparse and ms_sel is None:
            with tracing.span("vcbm25.stream.plan"):
                for rows, wsrc, q_start, w_ord, n_qb in self._dispatches(lists):
                    # The planning's order: each query's span holds its term
                    # runs in ordinal order, as S1's tile walk reads them.
                    plan = [_upload(x, self.device) for x in (wsrc, q_start, w_ord)]
                    with tracing.span("vcbm25.stream.launch"):
                        acc = stream_dense_accumulate(
                            self.dev_words, s1_eff, *self._window_tables(), *plan, n_qb, n_docs,
                        )
                        pending.append((rows, dense_topk(acc, kk, n_docs)))
                    # The accumulator (1 GiB at the budget) goes before the
                    # next dispatch allocates its own.
                    del acc
        elif use_sparse:
            with tracing.span("vcbm25.stream.plan"):
                sel = sparse_sel
                ssz = sizes[sel]
                # Cost bucketing: when padding every row to the longest wastes
                # over 65,536 windows, rows go to x4 size buckets.
                bucket_of = np.zeros(sel.size, dtype=np.int64)
                waste = sel.size * int(ssz.max(initial=0)) - int(ssz.sum())
                if waste > 65536:
                    b = 32
                    while np.any(ssz > b):
                        bucket_of[ssz > b] += 1
                        b *= 4
                for bu in np.unique(bucket_of):
                    bidx = sel[np.flatnonzero(bucket_of == bu)]
                    p_bucket = max(
                        1, _bucket(int(sizes[bidx].max(initial=1)), 8)
                    )
                    lane_cap = max(1, _LANE_CAP // (p_bucket * 128))
                    for i0 in range(0, bidx.size, lane_cap):
                        sub = bidx[i0 : i0 + lane_cap]
                        mt = int(max(1, n_terms[sub].max(initial=1)))
                        pending.append((sub, self._sparse_topk(s1_eff, lists, segs, sub, kk, mt)))

        payload_arr = np.asarray(self.segment.doc_payload)

        @tracing.traced("vcbm25.stream.finalize")
        def finalize():
            scores = np.full((qn, k), -np.inf, dtype=np.float32)
            ids = np.full((qn, k), -1, dtype=np.int64)
            payloads = np.full((qn, k), -1, dtype=np.int64)
            for sub, (s_dev, i_dev) in pending:
                # Dense rows are pow2-bucketed; drop the padding rows.  The
                # MaxScore tiers hand over host arrays.
                s = np.asarray(_host(s_dev))[: sub.size, :k]
                i = np.asarray(_host(i_dev)).astype(np.int64)[: sub.size, :k]
                if s.shape[1] < k:
                    pad = k - s.shape[1]
                    s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
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
        """Top-k for a batch of queries (contract: ExactEngine.search)."""
        return self.search_async(queries, k, filter_mask)()


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, its bytes counted as ``h2d_bytes``."""
    tracing.count("h2d_bytes", x.nbytes)
    return torch.from_numpy(x).to(device)


def _host(x, span: str = "vcbm25.stream.wait"):
    """A result block as numpy: device tensors are copied back (the wait
    ``span``, the bytes ``d2h_bytes``), the MaxScore tiers' host arrays pass
    as they are."""
    if not isinstance(x, torch.Tensor):
        return x
    with tracing.span(span):
        out = x.cpu().numpy()
    tracing.count("d2h_bytes", out.nbytes)
    return out
