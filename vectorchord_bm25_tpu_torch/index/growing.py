"""Growing segment on torch (counterpart of ``index/growing.py``, whose
body it copies): the device engine over the frozen prefix of the growing
postings is the port's ``StreamEngine`` on ``device``.

The reference's description follows.

Growing segment: append-only buffer for freshly inserted documents.

The reference appends inserted docs to a growing page chain scored by a
brute-force pass during every search (crates/bm25/src/insert.rs,
search.rs:83-135) until `maintain` merges them into the sealed segment.

Semantics pinned to the reference:

- growing docs are scored against the *sealed* segment's statistics
  (df, N, avgdl): the token list used by the brute-force pass comes from
  the sealed token table (search.rs:53-79), so terms that only exist in
  growing documents contribute nothing until the next maintain;
- the original (key, tf) vectors are retained so maintain can relabel and
  re-flush them (maintain.rs:167-255).

Host representation: a CSR of (sealed-term-id, tf) postings per growing
doc (term id -1 for sealed-unknown terms) plus the original Documents.
Scoring is a vectorized numpy pass (the growing segment stays small by
design — maintain seals it).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models.fieldnorm import length_to_fieldnorm
from ..text.intern import Document, Query
from ..utils import tracing
from .sealed import SealedSegment, build_sealed_segment_from_postings

__all__ = ["GrowingSegment"]


class GrowingSegment:
    """Append-only buffer of inserted docs, batch-served on ``device``."""

    def __init__(self, sealed: SealedSegment, device="cuda"):
        self.sealed = sealed
        self.device = torch.device(device)
        self.documents: List[Document] = []
        self.payloads: List[int] = []
        self.deleted: List[bool] = []
        self.fieldnorms: List[int] = []
        # CSR postings against the sealed token table.
        self._tid: List[np.ndarray] = []
        self._tf: List[np.ndarray] = []
        # Lazily built device engine over a FROZEN PREFIX of the growing
        # postings (batched serving).  Inserts do NOT invalidate it:
        # fresh docs beyond `_dev_engine_n` form a small host-scored
        # tail (the reference's brute-force growing chain,
        # search.rs:83-135) merged into every batch, and the engine is
        # rebuilt only when the tail outgrows the amortization
        # threshold — otherwise an insert burst between served batches
        # pays an O(G log G) rebuild per batch (measured 65x slowdown
        # at G=10k before this design).  Delete bits are refreshed in
        # place (cheap) — see device_engine() / topk_batch_async().
        self._dev_engine = None
        self._dev_engine_n = 0
        self._dev_engine_deleted_dirty = False
        # The engine's tokens' sealed ids, ascending: a sealed id's
        # position here is its token id in the engine.
        self._dev_tids = np.zeros(0, dtype=np.int64)
        # Flat tid-sorted postings of the tail [_dev_engine_n, G),
        # f32 impacts; invalidated by inserts (tail-sized rebuild).
        self._tail_flat = None

    def __len__(self) -> int:
        return len(self.documents)

    @property
    def n_live(self) -> int:
        return sum(not d for d in self.deleted)

    def insert(self, document: Document, payload: int) -> int:
        """Append one document (insert.rs:23-78 analog); returns its slot."""
        tids = self.sealed.lookup_tokens(document.keys)
        self.documents.append(document)
        self.payloads.append(int(payload))
        self.deleted.append(False)
        self.fieldnorms.append(int(length_to_fieldnorm(document.length())))
        self._tid.append(tids.astype(np.int64))
        self._tf.append(document.values.astype(np.int64))
        self._tail_flat = None
        return len(self.documents) - 1

    def bulkdelete(self, predicate) -> int:
        """Mark growing docs whose payload matches (bulkdelete.rs:40-77)."""
        from .bm25index import _eval_predicate

        mask = _eval_predicate(
            predicate, np.asarray(self.payloads, dtype=np.int64)
        )
        return self.apply_delete_mask(mask)

    def apply_delete_mask(self, mask: np.ndarray) -> int:
        """Flip delete bits for live docs under a boolean mask; returns count."""
        count = 0
        for i in np.flatnonzero(mask):
            if not self.deleted[i]:
                self.deleted[i] = True
                count += 1
        if count:
            self._dev_engine_deleted_dirty = True
        return count

    def score(
        self,
        query: Query,
        filter_fn=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Brute-force scores for all live growing docs against the query.

        Returns (scores float64 [G], payloads int64 [G]); scores use the
        sealed segment's Cache tables (search.rs:83-135 semantics) and
        are computed in FLOAT32 — per-posting impacts rounded to f32 and
        accumulated in f32, term-ascending per doc — exactly like the
        sealed engines, the device growing engine, and the reference
        (bm25.rs f32 idf/tf, search.rs f32 accumulation), so the single-
        query and batched paths rank near-ties identically.  Deleted /
        filtered docs score 0 (excluded by the score > 0 rule).
        """
        g = len(self.documents)
        scores = np.zeros(g, dtype=np.float32)
        if g == 0:
            return scores, np.zeros(0, dtype=np.int64)

        seg = self.sealed
        q_tids = seg.lookup_tokens(query.keys)
        q_tids = np.sort(q_tids[q_tids >= 0])
        if q_tids.size:
            tables = seg.score_tables()
            s0_all = seg.token_s0()
            tids = (
                np.concatenate(self._tid)
                if self._tid
                else np.zeros(0, dtype=np.int64)
            )
            tfs = (
                np.concatenate(self._tf)
                if self._tf
                else np.zeros(0, dtype=np.int64)
            )
            doc_of = np.repeat(
                np.arange(g, dtype=np.int64),
                [t.size for t in self._tid],
            )
            # Postings whose sealed term id is in the query's set.
            pos = np.searchsorted(q_tids, tids)
            pos = np.minimum(pos, q_tids.size - 1)
            hit = (tids >= 0) & (q_tids[pos] == tids)
            if np.any(hit):
                h_doc = doc_of[hit]
                h_tid = tids[hit]
                h_tf = tfs[hit].astype(np.float32)
                fn = np.asarray(self.fieldnorms, dtype=np.int64)[h_doc]
                s1 = tables.s1_table[fn].astype(np.float32)
                contrib = (
                    h_tf * s0_all[h_tid].astype(np.float32)
                ) / (h_tf + s1)
                # add.at applies in array order (doc-major, term-asc
                # within doc) — the device lane order, so f32 sums are
                # bit-identical.
                np.add.at(scores, h_doc, contrib.astype(np.float32))
            dead = np.asarray(self.deleted, dtype=bool)
            scores[dead] = 0.0
            if filter_fn is not None:
                from .bm25index import _eval_predicate

                keep = _eval_predicate(
                    filter_fn, np.asarray(self.payloads, dtype=np.int64)
                )
                scores[~keep] = 0.0
        return scores.astype(np.float64), np.asarray(
            self.payloads, dtype=np.int64
        )

    def _mini_segment(self):
        """The growing docs as a mini sealed segment keyed by sealed token
        id, with the sealed statistics to score it by: the reference's
        ``device_engine`` build (index/growing.py:268-326), which has no
        entry point of its own.  Returns (segment, global_stats, the
        segment's tokens' sealed ids, ascending)."""
        g = len(self.documents)
        # (tid, doc)-sorted raw postings with synthetic keys.
        tf_flat = np.concatenate(self._tf) if self._tf else np.zeros(0, np.int64)
        tid_flat = np.concatenate(self._tid) if self._tid else np.zeros(0, np.int64)
        known = tid_flat >= 0
        doc_flat = np.repeat(
            np.arange(g, dtype=np.int64), [t.size for t in self._tid]
        )[known]
        tid_known = tid_flat[known]
        order = np.lexsort((doc_flat, tid_known))
        t_s, d_s, tf_s = tid_known[order], doc_flat[order], tf_flat[known][order]
        kb = np.zeros((t_s.size, 16), dtype=np.uint8)
        if t_s.size:
            kb[:, :4] = t_s.astype(">u4").view(np.uint8).reshape(-1, 4)
        seg = build_sealed_segment_from_postings(
            kb.reshape(-1).view("S16"),
            d_s,
            tf_s,
            g,
            payloads=np.arange(max(g, 1), dtype=np.int64)[:g],
            options=getattr(self.sealed, "options", None),
            presorted=True,
        )
        # True fieldnorms (full doc length incl. sealed-unknown terms): the
        # build saw only known-term postings.
        seg.doc_fieldnorm = np.asarray(
            self.fieldnorms, dtype=seg.doc_fieldnorm.dtype
        )
        # Sealed s0 per mini-segment token.
        seg_tids = (
            seg.token_keys.view(np.uint8)
            .reshape(-1, 16)[:, :4]
            .copy()
            .view(">u4")
            .astype(np.int64)
            .reshape(-1)
        )
        s0v = self.sealed.token_s0()[seg_tids].astype(np.float32)
        return seg, (int(self.sealed.n_docs), int(self.sealed.sum_dl), s0v), seg_tids

    def device_engine(self):
        """The port's StreamEngine over a frozen prefix of the growing
        postings (reference ``device_engine``, index/growing.py:246-341):
        built on the first batch and whenever ``topk_batch_async`` drops it
        to absorb the tail; deletes only refresh its bitmap."""
        if self._dev_engine is None:
            from ..search.stream import StreamEngine

            tracing.count("growing_rebuilds")
            with tracing.span("vcbm25.growing.rebuild"):
                seg, stats, self._dev_tids = self._mini_segment()
                self._dev_engine = StreamEngine(
                    seg, global_stats=stats, device=self.device
                )
            self._dev_engine_n = len(self.documents)
            self._tail_flat = None
            self._dev_engine.set_deleted(np.asarray(self.deleted, dtype=bool))
            self._dev_engine_deleted_dirty = False
        elif self._dev_engine_deleted_dirty:
            self._dev_engine.set_deleted(
                np.asarray(self.deleted[: self._dev_engine_n], dtype=bool)
            )
            self._dev_engine_deleted_dirty = False
        return self._dev_engine

    @tracing.traced("vcbm25.growing.dispatch")
    def topk_batch_async(self, ids, qidx, qn: int, k: int, keep):
        """Dispatch the growing top-k of a batch of ``qn`` queries looked
        up in the SEALED token table (``ids``, ``qidx`` as
        ``batch_lookup`` gives them), overlappable with the sealed
        dispatch; ``keep``: an optional [G] bool mask (prefilter).  Returns
        finalize() -> a list of result blocks, each (scores [Q, w] float64
        -inf-padded, idx [Q, w] int64 growing ids, -1-padded) ranked
        (score desc, id asc) within a query: the prefix's, then the
        tail's when there is one, unmerged (the facade ranks them with
        the sealed results in one sort).

        Two-level serving: the device engine covers the frozen prefix
        [0, _dev_engine_n); docs inserted since are scored on host
        (same f32 semantics) — so an insert burst between served
        batches costs O(tail), not an O(G log G) engine rebuild per
        batch.  The engine is rebuilt (absorbing the tail) only when the
        tail exceeds max(512, min(n0/8, 4096)) docs.
        """
        g = len(self.documents)
        if g == 0 or qn == 0:
            return lambda: []
        n0 = self._dev_engine_n if self._dev_engine is not None else 0
        if self._dev_engine is None or g - n0 > max(
            512, min(n0 // 8, 4096)
        ):
            self._dev_engine = None  # rebuild absorbs the tail
        engine = self.device_engine()
        n0 = self._dev_engine_n
        # The sealed lookup serves the engine and the tail: a sealed id's
        # token id in the engine is its rank among the engine's sealed ids;
        # ids the engine lacks drop out, and within a query the ranks
        # ascend as the sealed ids do.
        with tracing.span("vcbm25.growing.lookup"):
            pos = np.searchsorted(self._dev_tids, ids)
            found = pos < self._dev_tids.size
            found[found] = self._dev_tids[pos[found]] == ids[found]
            eng_ids, eng_qidx = pos[found], qidx[found]
        fmask = None
        if keep is not None:
            fmask = np.asarray(keep, dtype=np.float32)[:n0]
        fin = engine.search_ids_async(eng_ids, eng_qidx, qn, k, filter_mask=fmask)
        tail = (
            self._tail_topk(ids, qidx, qn, k, keep) if g > n0 else None
        )

        @tracing.traced("vcbm25.growing.finalize")
        def finalize():
            s_f32, dids, _ = fin()
            s = s_f32.astype(np.float64)
            dids = np.asarray(dids, dtype=np.int64)
            s[dids < 0] = -np.inf
            return [(s, dids)] if tail is None else [(s, dids), tail]

        return finalize

    @tracing.traced("vcbm25.growing.tail")
    def _tail_topk(self, ids, qidx, qn, k, keep):
        """Host top-k over the tail docs [_dev_engine_n, G) — the
        reference's brute-force growing-chain pass (search.rs:83-135)
        applied to only the docs the device engine has not absorbed.
        ``ids``/``qidx``: the batch's sealed ids and their queries, as
        ``batch_lookup`` gives them (ids ascending within a query).

        Only the (query, tail posting) pairs the batch touches are
        scored, counted as ``growing_tail_pairs``: each (query, doc)
        group summed in f32 in term-ascending order, matching the device
        engine's lane accumulation, so prefix/tail near-ties rank
        identically however the rebuild falls; then deleted, filtered
        and score <= 0 docs dropped and the rest ranked (score desc, id
        asc).

        Returns (scores [Q, m] float64 -inf-padded, idx [Q, m] int64
        GLOBAL growing ids, -1-padded), m = min(k, tail)."""
        from ..utils.batchkeys import group_positions

        n0 = self._dev_engine_n
        g = len(self.documents)
        tn = g - n0
        m = min(k, tn)
        scores_out = np.full((qn, m), -np.inf, dtype=np.float64)
        idx_out = np.full((qn, m), -1, dtype=np.int64)
        if self._tail_flat is None or self._tail_flat[0] != n0:
            tids = (
                np.concatenate(self._tid[n0:])
                if tn
                else np.zeros(0, dtype=np.int64)
            )
            tfs = (
                np.concatenate(self._tf[n0:]).astype(np.float32)
                if tn
                else np.zeros(0, dtype=np.float32)
            )
            doc_of = np.repeat(
                np.arange(tn, dtype=np.int64),
                [t.size for t in self._tid[n0:]],
            )
            known = tids >= 0
            tids, tfs, doc_of = tids[known], tfs[known], doc_of[known]
            order = np.argsort(tids, kind="stable")
            tids, tfs, doc_of = tids[order], tfs[order], doc_of[order]
            if tids.size:
                tables = self.sealed.score_tables()
                s0 = self.sealed.token_s0().astype(np.float32)
                fn = np.asarray(self.fieldnorms, dtype=np.int64)[
                    n0 + doc_of
                ]
                s1 = tables.s1_table[fn].astype(np.float32)
                impact = (tfs * s0[tids]) / (tfs + s1)
            else:
                impact = np.zeros(0, dtype=np.float32)
            self._tail_flat = (n0, tids, impact.astype(np.float32), doc_of)
        _, tids, impact, doc_of = self._tail_flat
        # The (query, posting) pairs: in query order, a query's ids
        # ascending, a term's postings in doc order.
        lo = np.searchsorted(tids, ids, side="left")
        cnt = np.searchsorted(tids, ids, side="right") - lo
        src = np.repeat(lo, cnt) + group_positions(cnt)
        tracing.count("growing_tail_pairs", src.size)
        if m == 0 or src.size == 0:
            return scores_out, idx_out
        # Group by (query, doc); the stable sort keeps each group's
        # postings term-ascending.
        key = np.repeat(qidx, cnt) * tn + doc_of[src]
        order = np.argsort(key, kind="stable")
        key = key[order]
        imp = impact[src[order]]
        head = np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))
        size = np.diff(np.append(head, key.size))
        # f32 sums in term order: the j-th posting of every group in pass j.
        s = imp[head]
        for j in range(1, int(size.max())):
            more = size > j
            s[more] += imp[head[more] + j]
        q, d = np.divmod(key[head], tn)
        drop = np.asarray(self.deleted[n0:], dtype=bool)
        if keep is not None:
            drop = drop | ~np.asarray(keep, dtype=bool)[n0:]
        live = (s > 0.0) & ~drop[d]
        q, d, s = q[live], d[live], s[live]
        # Rank (score desc, id asc) within each query and keep m.  The
        # groups are in (query, id) order, so one stable sort on (query,
        # score desc) leaves equal scores in id order; a positive f32's
        # bits order as its value does.
        rank = np.argsort(
            (q << 31) | (0x7FFFFFFF - s.view(np.int32)).astype(np.int64),
            kind="stable",
        )
        q, d, s = q[rank], d[rank], s[rank]
        col = group_positions(np.bincount(q, minlength=qn))
        top = col < m
        scores_out[q[top], col[top]] = s[top]
        idx_out[q[top], col[top]] = d[top] + n0
        return scores_out, idx_out

    def live_documents(self) -> List[Tuple[int, Document]]:
        """(payload, document) pairs of live docs, in insertion order
        (maintain pass C ordering, maintain.rs:167-255)."""
        return [
            (self.payloads[i], self.documents[i])
            for i in range(len(self.documents))
            if not self.deleted[i]
        ]
