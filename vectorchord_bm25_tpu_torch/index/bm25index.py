"""Bm25Index on torch: the top-level mutable index facade (counterpart of
``index/bm25index.py``, whose body it copies).

The sealed segment is served by the port's ``StreamEngine`` (the default),
``BlockMaxEngine``, ``ExactEngine`` or ``HybridEngine`` on ``device``, and
a non-empty growing segment by the port's ``GrowingSegment`` on the same
device.  ``from_reference`` takes over an index of the JAX package (e.g. a
checkpoint read by its ``load_index``) by value.

Combines the immutable sealed segment (device-resident, engine-scored)
with the growing segment (host brute-force), a delete bitmap, and the
maintain/merge cycle — the capability surface of the reference extension:

    build       <- CREATE INDEX        (am_build.rs, bm25::build)
    insert      <- aminsert            (insert.rs)
    bulkdelete  <- ambulkdelete        (bulkdelete.rs)
    maintain    <- amvacuumcleanup     (maintain.rs)
    search      <- amgettuple top-k    (search.rs)
    evaluate    <- the <&> operator    (evaluate.rs, operators.rs)

Pinned semantics (see SURVEY.md §3):
- results contain only docs with score > 0, at most k, ordered by
  (score desc, insertion order asc);
- inserted docs are visible to search immediately (growing brute force)
  but scored with the sealed segment's statistics until maintain;
- deleted docs are masked at scoring; maintain relabels live docs
  (sealed slot order first, then growing insertion order) and re-flushes
  everything into a fresh sealed segment;
- `evaluate` returns the positive BM25 score of (document, query);
  `operator_score` negates it (ORDER BY ascending = most relevant first,
  operators.rs:22-55).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.fieldnorm import length_to_fieldnorm
from ..models.scoring import idf as idf_fn, tf as tf_fn
from ..ops import launch_count
from ..text.intern import Document, Query, random_seed
from ..utils import tracing
from ..utils.batchkeys import batch_lookup
from ..utils.options import IndexOptions, SearchOptions, SessionConfig
from .growing import GrowingSegment
from .sealed import SealedSegment, build_sealed_segment, segment_from_reference

__all__ = ["Bm25Index", "BoundQuery", "SearchHit", "merge_ranked"]

def _eval_predicate(predicate, payloads: np.ndarray) -> np.ndarray:
    """Evaluate a payload predicate over an int64 array, preferring one
    vectorized numpy call; scalar-only predicates (anything that raises or
    returns a non-conforming result on the array) fall back to a fromiter
    sweep."""
    if payloads.size == 0:
        return np.zeros(0, dtype=bool)
    try:
        result = np.asarray(predicate(payloads))
        if result.shape == payloads.shape and result.dtype == np.bool_:
            return result
    except Exception:
        pass
    return np.fromiter(
        (bool(predicate(int(p))) for p in payloads),
        dtype=bool,
        count=payloads.size,
    )


def merge_ranked(blocks, k: int):
    """One ranking of a batch's result blocks, each (scores [Q, w]
    float64, ids [Q, w] int64, payloads [Q, w] int64) with pads at -inf
    and id -1: every block's columns side by side, ranked per query by
    score descending, then id ascending, pads last (after real ids at an
    equal -inf score, in block order).  Returns the first k columns of
    (scores, ids, payloads)."""
    scores = np.concatenate([b[0] for b in blocks], axis=1)
    ids = np.concatenate([b[1] for b in blocks], axis=1)
    payloads = np.concatenate([b[2] for b in blocks], axis=1)
    order = np.where(ids < 0, np.iinfo(np.int64).max, ids)
    pick = np.lexsort((order, -scores), axis=-1)[:, :k]
    return tuple(np.take_along_axis(x, pick, axis=1) for x in (scores, ids, payloads))


class BoundQuery:
    """A query bound to a specific index (the `to_bm25query(vec, index)`
    analog).  Searching a different index with it errors, mirroring the
    reference's "query's index oid != scanned index" check
    (src/index/bm25/scanners/default.rs:79-84)."""

    __slots__ = ("query", "index_seed")

    def __init__(self, query: Query, index_seed: bytes):
        self.query = query
        self.index_seed = index_seed


class SearchHit(tuple):
    """(score, payload) pair; score is the positive BM25 score."""

    __slots__ = ()

    def __new__(cls, score: float, payload: int):
        return tuple.__new__(cls, (float(score), int(payload)))

    @property
    def score(self) -> float:
        return self[0]

    @property
    def payload(self) -> int:
        return self[1]

    @property
    def operator_score(self) -> float:
        """The <&> operator value: negated score (operators.rs:54)."""
        return -self[0]


def _hit_lists(
    scores: np.ndarray, payloads: np.ndarray
) -> List[List[SearchHit]]:
    """A batch's ``[Q, w]`` scores and payloads as Q lists of
    ``SearchHit``, one a row, each keeping its row's finite lanes in lane
    order (pads at -inf and NaN lanes drop out).

    The whole batch goes to Python scalars in one ``tolist()`` a matrix
    (Python ``float`` and ``int`` already, so the hits skip
    ``SearchHit.__new__``'s conversions) and to hits in one pass; rows are
    list slices of that pass, and only rows with a lane that is not finite
    are filtered again by their mask.  Counts ``hits`` and
    ``hit_rows_short`` (the rows filtered again)."""
    q, w = scores.shape
    valid = np.isfinite(scores)
    flat = list(
        map(
            tuple.__new__,
            itertools.repeat(SearchHit),
            zip(scores.ravel().tolist(), payloads.ravel().tolist()),
        )
    )
    out = [flat[i * w : (i + 1) * w] for i in range(q)]
    short = np.flatnonzero(~valid.all(axis=1)).tolist()
    for i in short:
        out[i] = list(itertools.compress(out[i], valid[i].tolist()))
    if tracing.active():
        tracing.count("hits", int(np.count_nonzero(valid)))
        tracing.count("hit_rows_short", len(short))
    return out


class Bm25Index:
    def __init__(
        self,
        sealed: SealedSegment,
        seed: bytes,
        options: IndexOptions,
        search_options: Optional[SearchOptions] = None,
        engine: str = "stream",
        engine_options: Optional[dict] = None,
        device="cuda",
    ):
        if engine not in ("exact", "blockmax", "hybrid", "stream"):
            raise ValueError(f"unknown engine {engine!r}")
        self.options = options
        self.search_options = search_options or SearchOptions()
        # Extra kwargs forwarded to the engine constructor (e.g.
        # {"strategy": "maxscore"} for the pruned stream strategy).
        self.engine_options = dict(engine_options or {})
        self.seed = seed
        self.sealed = sealed
        self.deleted = np.zeros(sealed.n_docs, dtype=bool)
        self.device = torch.device(device)
        self.growing = GrowingSegment(sealed, device=self.device)
        self.engine_kind = engine
        self._engine = None
        self._engine_deleted_dirty = False
        # Concurrency discipline (the reference's lock-page protocol,
        # maintain.rs:44 / bulkdelete.rs:34): searches and point mutations
        # take the RW lock shared, maintain takes it exclusive for the
        # generation swap; a separate mutex serializes host-state writers.
        from ..utils.rwlock import RWLock

        self._rw = RWLock()
        self._mutex = threading.RLock()
        # Optional write-ahead log (storage.Wal); mutations are logged and
        # fsynced before being acknowledged (the GenericXLog analog,
        # src/index/storage.rs:227-238).
        self._wal = None
        # Prefilter masks keyed by predicate object: sealed payloads only
        # change at maintain (which clears this), so repeated filtered
        # searches reuse one vectorized evaluation.
        self._prefilter_cache: dict = {}

    def attach_wal(self, wal) -> None:
        self._wal = wal

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        documents: Sequence[Document],
        payloads: Optional[Sequence[int]] = None,
        options: Optional[IndexOptions] = None,
        search_options: Optional[SearchOptions] = None,
        seed: Optional[bytes] = None,
        engine: str = "stream",
        engine_options: Optional[dict] = None,
        reorder: str = "none",
        progress=None,
        device="cuda",
    ) -> "Bm25Index":
        """CREATE INDEX analog, served on ``device``.

        reorder: doc-id assignment strategy ("none", "fieldnorm", "term");
        clustering strategies tighten block-max bounds (index/reorder.py).
        """
        options = options or IndexOptions()
        seed = seed if seed is not None else random_seed()
        documents = list(documents)
        if payloads is None:
            payloads = np.arange(len(documents), dtype=np.int64)
        if reorder != "none":
            from .reorder import reorder_documents

            documents, payloads = reorder_documents(
                documents, np.asarray(payloads, dtype=np.int64), reorder
            )
        sealed = build_sealed_segment(
            documents, payloads=payloads, options=options, progress=progress
        )
        return cls(
            sealed, seed, options, search_options,
            engine=engine, engine_options=engine_options, device=device,
        )

    @classmethod
    def from_reference(cls, ref, device="cuda", engine_options=None) -> "Bm25Index":
        """Port index over a copy of a reference index's host state (sealed
        segment, delete bitmap, growing segment, seed, options, engine and
        engine options), e.g. a checkpoint read by the JAX package's
        ``index/storage.py:load_index``.  Everything is copied by value
        into the port's own classes.  ``engine_options``, when given,
        replaces the reference's."""
        if engine_options is None:
            engine_options = ref.engine_options
        so = ref.search_options
        index = cls(
            segment_from_reference(ref.sealed),
            bytes(ref.seed),
            IndexOptions(k1=ref.options.k1, b=ref.options.b),
            SearchOptions(limit=so.limit, prefilter=so.prefilter),
            engine=ref.engine_kind,
            engine_options=engine_options,
            device=device,
        )
        index.deleted = np.array(ref.deleted, dtype=bool)
        for doc, payload in zip(ref.growing.documents, ref.growing.payloads):
            index.growing.insert(Document(keys=doc.keys, values=doc.values), payload)
        index.growing.apply_delete_mask(np.array(ref.growing.deleted, dtype=bool))
        return index

    # ------------------------------------------------------------------
    @property
    def n_docs(self) -> int:
        """Live documents across sealed + growing."""
        return int((~self.deleted).sum()) + self.growing.n_live

    def engine(self):
        with self._mutex:
            return self._engine_locked()

    def _engine_locked(self):
        if self._engine is None:
            kw = self.engine_options
            if self.engine_kind == "stream":
                from ..search.stream import StreamEngine

                self._engine = StreamEngine(self.sealed, device=self.device, **kw)
            elif self.engine_kind == "blockmax":
                from ..search.blockmax import BlockMaxEngine

                self._engine = BlockMaxEngine(self.sealed, device=self.device, **kw)
            elif self.engine_kind == "hybrid":
                from ..search.hybrid import HybridEngine

                self._engine = HybridEngine(self.sealed, device=self.device, **kw)
            else:
                from ..search.exact import ExactEngine

                self._engine = ExactEngine(self.sealed, device=self.device, **kw)
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        elif self._engine_deleted_dirty:
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        return self._engine

    # ------------------------------------------------------------------
    def insert(self, document: Document, payload: int) -> None:
        """aminsert analog: append to the growing segment."""
        with self._rw.read(), self._mutex, tracing.span("vcbm25.growing.insert"):
            self.growing.insert(document, payload)
            if self._wal is not None:
                import base64

                self._wal.append(
                    {
                        "op": "insert",
                        "payload": int(payload),
                        "keys": base64.b64encode(
                            document.keys.tobytes()
                        ).decode(),
                        "values": document.values.tolist(),
                    }
                )

    def bulkdelete(self, predicate: Callable[[int], bool]) -> int:
        """Mark docs whose payload matches; returns count marked
        (bulkdelete.rs: flips deleted bits in both segments).

        Vectorized: the predicate is first applied to the whole payload
        array (numpy-broadcastable predicates run in one pass); scalar-only
        predicates fall back to a single fromiter sweep.  Unlike the
        reference's per-page walk (bulkdelete.rs:79-111) this touches no
        per-doc Python objects.
        """
        with self._rw.read(), self._mutex:
            mask = _eval_predicate(predicate, self.sealed.doc_payload)
            g_mask = _eval_predicate(
                predicate, np.asarray(self.growing.payloads, dtype=np.int64)
            )
            return self._bulkdelete_masks(mask, g_mask)

    def bulkdelete_payloads(self, payloads) -> int:
        """Delete by explicit payload set (np.isin fast path)."""
        targets = np.asarray(
            list(payloads) if not isinstance(payloads, np.ndarray) else payloads,
            dtype=np.int64,
        )
        with self._rw.read(), self._mutex:
            mask = np.isin(self.sealed.doc_payload, targets)
            g_mask = np.isin(
                np.asarray(self.growing.payloads, dtype=np.int64), targets
            )
            return self._bulkdelete_masks(mask, g_mask)

    def _bulkdelete_masks(
        self, sealed_mask: np.ndarray, growing_mask: np.ndarray
    ) -> int:
        """Flip delete bits for live docs under the masks; WAL-log the
        newly deleted slots (deterministic, predicate-free)."""
        newly = sealed_mask & ~self.deleted
        count = int(newly.sum())
        if count:
            self.deleted |= newly
            self._engine_deleted_dirty = True
        g_dead = np.asarray(self.growing.deleted, dtype=bool)
        g_newly = growing_mask & ~g_dead
        g_slots = np.flatnonzero(g_newly)
        # Through apply_delete_mask so the device engine's bitmap is
        # marked stale (it re-uploads on the next batched search).
        self.growing.apply_delete_mask(g_newly)
        total = count + int(g_slots.size)
        if total and self._wal is not None:
            self._wal.append(
                {
                    "op": "delete",
                    "sealed": np.flatnonzero(newly).tolist(),
                    "growing": g_slots.tolist(),
                }
            )
        return total

    def maintain(self, progress=None) -> None:
        """Merge/compaction (maintain.rs): relabel live docs — sealed slot
        order then growing insertion order — and re-flush into a fresh
        sealed segment; the growing segment empties.  Takes the index
        lock exclusive for the whole merge (the reference holds its lock
        page exclusive likewise)."""
        with self._rw.write():
            self._maintain_locked(progress)
            if self._wal is not None:
                self._wal.append({"op": "maintain"})

    def _maintain_locked(self, progress=None) -> None:
        """Fully vectorized merge (no per-doc Python objects):

        - pass A (relabel, maintain.rs:56-73 analog): old->new doc-id map
          via a cumulative sum over the live bitmap;
        - pass B (re-emit, maintain.rs:104-161): masked flatten of the
          sealed block arrays — relabel is monotonic, so the (token, doc)
          posting order is preserved and no re-sort is needed;
        - pass C (growing drain, maintain.rs:167-255): growing postings are
          mapped into the union vocabulary and merged with a single packed
          (token_id << 32 | doc_id) u64 sort.
        """
        from .sealed import build_sealed_segment_from_postings

        seg = self.sealed
        live = ~self.deleted
        n_live_sealed = int(live.sum())
        new_id = np.cumsum(live, dtype=np.int64) - 1  # valid where live

        # Pass A+B: surviving sealed postings, relabeled.
        if seg.n_docs and seg.n_blocks:
            tok, doc, tfv = seg.postings()
            keep = live[doc]
            s_tid = tok[keep].astype(np.int64)
            s_doc = new_id[doc[keep]]
            s_tf = tfv[keep].astype(np.int64)
        else:
            s_tid = np.zeros(0, dtype=np.int64)
            s_doc = np.zeros(0, dtype=np.int64)
            s_tf = np.zeros(0, dtype=np.int64)
        payloads = seg.doc_payload[live]

        # Pass C: live growing docs (flat arrays; Documents only provide
        # their already-built key/value arrays).
        g_live = [
            i for i, d in enumerate(self.growing.deleted) if not d
        ]
        n_new = n_live_sealed + len(g_live)
        vocab = seg.token_keys
        if g_live:
            g_docs = [self.growing.documents[i] for i in g_live]
            g_counts = np.fromiter(
                (len(d) for d in g_docs), dtype=np.int64, count=len(g_docs)
            )
            if int(g_counts.sum()):
                g_keys = np.concatenate([d.keys for d in g_docs])
                g_tf = np.concatenate(
                    [d.values for d in g_docs]
                ).astype(np.int64)
            else:
                g_keys = np.zeros(0, dtype=seg.token_keys.dtype)
                g_tf = np.zeros(0, dtype=np.int64)
            g_doc = n_live_sealed + np.repeat(
                np.arange(len(g_live), dtype=np.int64), g_counts
            )
            payloads = np.concatenate(
                [
                    payloads,
                    np.asarray(
                        [self.growing.payloads[i] for i in g_live],
                        dtype=np.int64,
                    ),
                ]
            )
            if g_keys.size:
                # Union vocabulary; remap both posting streams into it.
                vocab = np.union1d(seg.token_keys, g_keys)
                if seg.token_keys.size:
                    s_tid = np.searchsorted(vocab, seg.token_keys)[s_tid]
                g_tid = np.searchsorted(vocab, g_keys)
                all_tid = np.concatenate([s_tid, g_tid])
                all_doc = np.concatenate([s_doc, g_doc])
                all_tf = np.concatenate([s_tf, g_tf])
                # One u64 key sort restores (token, doc) order.
                packed = (all_tid.astype(np.uint64) << np.uint64(32)) | all_doc.astype(
                    np.uint64
                )
                order = np.argsort(packed)
                s_tid, s_doc, s_tf = (
                    all_tid[order],
                    all_doc[order],
                    all_tf[order],
                )

        new_sealed = build_sealed_segment_from_postings(
            None,
            s_doc,
            s_tf,
            n_new,
            payloads=payloads,
            options=self.options,
            progress=progress,
            presorted=True,
            token_ids=s_tid,
            vocab_keys=vocab,
        )
        # Atomic generation swap (the jump-tuple swap analog).
        self.sealed = new_sealed
        self.deleted = np.zeros(new_sealed.n_docs, dtype=bool)
        self.growing = GrowingSegment(new_sealed, device=self.device)
        self._engine = None
        self._prefilter_cache.clear()

    # ------------------------------------------------------------------
    def search(
        self,
        query: Query,
        k: Optional[int] = None,
        filter_fn: Optional[Callable[[int], bool]] = None,
        session: Optional[SessionConfig] = None,
    ) -> List[SearchHit]:
        """Top-k search merging sealed (device) and growing (host) results.

        filter_fn: payload predicate.  With prefilter enabled (reloption /
        session override, the reference's `prefilter` semantics) it is
        evaluated inside retrieval so the top-k threshold stays honest;
        otherwise it is applied to the k retrieved results (the planner-
        applies-quals-afterwards behavior), which can return fewer than k.
        """
        query = self._unbind(query)
        sess = session or SessionConfig()
        if k is None:
            k = sess.resolve_limit(self.search_options)
        if filter_fn is not None and not sess.resolve_prefilter(
            self.search_options
        ):
            # Post-filter mode: retrieve unfiltered, filter the results.
            hits = self.search(query, k=k, filter_fn=None, session=session)
            return [h for h in hits if filter_fn(h.payload)]
        if not sess.enable_scan:
            # bm25.enable_scan = off: bypass the index scan and use the
            # brute-force path (the reference's planner then orders a
            # seqscan by the <&> operator, src/index/bm25/am/mod.rs:209-258).
            if k <= 0 and k != -1:
                raise ValueError("number of needed rows is set to 0")
            hits = self.search_all(query, filter_fn)
            return hits if k == -1 else hits[:k]
        if k == -1:
            # 0.2.x bm25_catalog.bm25_limit = -1: brute force, return every
            # document with score > 0 (README.md:462-466).
            return self.search_all(query, filter_fn)
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        with self._rw.read():
            return self._search_locked(query, k, filter_fn)

    def _unbind(self, query):
        if isinstance(query, BoundQuery):
            if query.index_seed != self.seed:
                raise ValueError(
                    "bm25 query references another index (rebuild the "
                    "query against this index)"
                )
            return query.query
        return query

    def make_query(self, tokens) -> BoundQuery:
        """to_bm25query analog: intern tokens against this index's seed and
        bind the query to this index."""
        return BoundQuery(Query.from_tokens(self.seed, tokens), self.seed)

    def search_all(
        self,
        query: Query,
        filter_fn: Optional[Callable[[int], bool]] = None,
    ) -> List[SearchHit]:
        """Brute-force: every matching doc (score > 0), best first — the
        0.2.x bm25_limit = -1 behavior."""
        query = self._unbind(query)
        with self._rw.read():
            from ..search.exact import oracle_scores

            hits: List[Tuple[float, int, int]] = []
            if self.sealed.n_docs:
                scores = oracle_scores(
                    self.sealed, query, deleted=self.deleted, dtype=np.float64
                )
                for slot in np.flatnonzero(scores > 0):
                    payload = int(self.sealed.doc_payload[slot])
                    if filter_fn is None or filter_fn(payload):
                        hits.append((float(scores[slot]), int(slot), payload))
            g_scores, g_payloads = self.growing.score(query, filter_fn=filter_fn)
            base = self.sealed.n_docs
            hits += [
                (float(s), base + i, int(p))
                for i, (s, p) in enumerate(zip(g_scores, g_payloads))
                if s > 0.0
            ]
            hits.sort(key=lambda t: (-t[0], t[1]))
            return [SearchHit(s, p) for s, _, p in hits]

    def _sealed_filter_mask(self, filter_fn) -> Optional[np.ndarray]:
        """Vectorized prefilter mask over sealed payloads, cached per
        predicate object (payloads are immutable between maintains)."""
        if filter_fn is None:
            return None
        cache = self._prefilter_cache
        try:
            mask = cache.get(filter_fn)
        except TypeError:  # unhashable predicate
            return _eval_predicate(filter_fn, self.sealed.doc_payload)
        if mask is None:
            mask = _eval_predicate(filter_fn, self.sealed.doc_payload)
            if len(cache) >= 16:
                cache.clear()
            cache[filter_fn] = mask
        return mask

    def _search_locked(self, query, k, filter_fn):
        # Sealed path.
        sealed_hits: List[Tuple[float, int, int]] = []  # (score, order, payload)
        if self.sealed.n_docs:
            mask = self._sealed_filter_mask(filter_fn)
            scores, slots, payloads = self.engine().search(
                [query], k, filter_mask=mask
            )
            for s, slot, payload in zip(scores[0], slots[0], payloads[0]):
                if slot >= 0:
                    sealed_hits.append((float(s), int(slot), int(payload)))

        # Growing path (scored with sealed stats).
        g_scores, g_payloads = self.growing.score(query, filter_fn=filter_fn)
        g_base = self.sealed.n_docs
        growing_hits = [
            (float(s), g_base + i, int(p))
            for i, (s, p) in enumerate(zip(g_scores, g_payloads))
            if s > 0.0
        ]

        merged = sealed_hits + growing_hits
        merged.sort(key=lambda t: (-t[0], t[1]))
        return [SearchHit(s, p) for s, _, p in merged[:k]]

    def search_batch(
        self,
        queries: Sequence[Query],
        k: int,
        filter_fn: Optional[Callable[[int], bool]] = None,
        session: Optional[SessionConfig] = None,
    ) -> List[List[SearchHit]]:
        """Batched search (the TPU fast path); growing docs merged per
        query with one vectorized pass over the whole batch.

        filter_fn follows `search`'s semantics: evaluated inside
        retrieval when prefilter is enabled (reloption / session
        override), applied to the k results otherwise.
        """
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        sess = session or SessionConfig()
        if filter_fn is not None and not sess.resolve_prefilter(
            self.search_options
        ):
            unfiltered = self.search_batch(queries, k)
            return [
                [h for h in hits if filter_fn(h.payload)]
                for hits in unfiltered
            ]
        with self._rw.read():
            return self._search_batch_dispatch(queries, k, filter_fn)()

    def search_batch_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_fn: Optional[Callable[[int], bool]] = None,
        session: Optional[SessionConfig] = None,
    ):
        """Dispatch a batch and return finalize() -> search_batch's result.

        The pipelined form of `search_batch`: successive batches overlap
        host prep, device compute, and result transfer (the growing
        segment's second device dispatch rides the same pipeline, so a
        non-empty growing segment costs overlap, not a serialized round
        trip per batch).  The read lock is held during dispatch only;
        results reflect the index state at dispatch time (device inputs
        are immutable snapshots), matching acknowledged-at-dispatch
        semantics.
        """
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        sess = session or SessionConfig()
        if filter_fn is not None and not sess.resolve_prefilter(
            self.search_options
        ):
            fin = self.search_batch_async(queries, k)

            def post_filtered():
                return [
                    [h for h in hits if filter_fn(h.payload)]
                    for hits in fin()
                ]

            return post_filtered
        with self._rw.read():
            return self._search_batch_dispatch(queries, k, filter_fn)

    def _search_batch_dispatch(self, queries, k, filter_fn=None):
        """Dispatch sealed + growing device work under the read lock;
        the returned finalize() syncs and merges (lock-free: all inputs
        were snapshotted at dispatch).  The batch's dispatch and finalize
        are the root spans ``vcbm25.facade.dispatch`` and
        ``vcbm25.facade.finalize`` under one batch id (utils/tracing.py)."""
        batch = tracing.next_batch()
        on = tracing.active()
        launches = launch_count() if on else 0
        with tracing.span("vcbm25.facade.dispatch", batch):
            with tracing.span("vcbm25.facade.unbind"):
                queries = [self._unbind(q) for q in queries]
            finalize = self._dispatch_locked(queries, k, filter_fn, batch)
        if on:
            tracing.count("batches")
            tracing.count("queries", len(queries))
            tracing.count("kernel_calls", launch_count() - launches)
        return finalize

    def _dispatch_locked(self, queries, k, filter_fn, batch):
        """The growing and sealed dispatches of unbound ``queries``, both
        served from one lookup of the batch in the sealed token table;
        returns the batch's finalize(), which ranks the sealed, growing
        prefix and tail results in one merge."""
        qn = len(queries)
        with tracing.span("vcbm25.facade.lookup"):
            ids, qidx = batch_lookup(self.sealed.lookup_tokens, queries)
        g = len(self.growing)
        g_fin = None
        g_payloads = None
        if g:
            # Dispatch the growing segment's device top-k first so it
            # overlaps the sealed dispatch below.
            g_payloads = np.asarray(self.growing.payloads, dtype=np.int64)
            keep = (
                _eval_predicate(filter_fn, g_payloads)
                if filter_fn is not None
                else None
            )
            g_fin = self.growing.topk_batch_async(ids, qidx, qn, k, keep)

        g_base = self.sealed.n_docs
        if self.sealed.n_docs:
            mask = self._sealed_filter_mask(filter_fn)
            s_fin = self.engine().search_ids_async(ids, qidx, qn, k, filter_mask=mask)
        else:
            s_fin = None

        def finalize():
            with tracing.span("vcbm25.facade.finalize", batch):
                return results()

        def results():
            if s_fin is not None:
                scores, slots, payloads = s_fin()
                scores = scores.astype(np.float64)
                slots = np.asarray(slots, dtype=np.int64)
                payloads = np.asarray(payloads, dtype=np.int64)
                scores[slots < 0] = -np.inf
            else:
                scores = np.full((qn, k), -np.inf, dtype=np.float64)
                slots = np.full((qn, k), -1, dtype=np.int64)
                payloads = np.full((qn, k), -1, dtype=np.int64)

            if g:
                g_blocks = g_fin()
                with tracing.span("vcbm25.facade.merge"):
                    # Sealed slots, then growing ids after them: one
                    # (score desc, id asc) ranking of every block.
                    scores, _, payloads = merge_ranked(
                        [(scores, slots, payloads)]
                        + [
                            (s, np.where(i >= 0, g_base + i, -1), g_payloads[np.maximum(i, 0)])
                            for s, i in g_blocks
                        ],
                        k,
                    )

            with tracing.span("vcbm25.facade.hits"):
                return _hit_lists(scores, payloads)

        return finalize

    # ------------------------------------------------------------------
    def evaluate(self, document: Document, query: Query) -> float:
        """Exact BM25 score of one (document, query) pair using the sealed
        statistics (evaluate.rs:22-74).  Positive score; see
        `operator_score` for the <&> convention."""
        seg = self.sealed
        if seg.n_docs == 0:
            return 0.0
        fieldnorm = int(length_to_fieldnorm(document.length()))
        avgdl = seg.avgdl
        tids = seg.lookup_tokens(document.keys)
        q_tids = seg.lookup_tokens(query.keys)
        doc_map = {
            int(t): int(v)
            for t, v in zip(tids, document.values)
            if t >= 0
        }
        total = 0.0
        for t in q_tids:
            t = int(t)
            if t < 0 or t not in doc_map:
                continue
            total += float(
                idf_fn(seg.n_docs, int(seg.token_df[t]))
                * tf_fn(
                    fieldnorm,
                    doc_map[t],
                    self.options.k1,
                    self.options.b,
                    avgdl,
                )
            )
        return total

    def operator_score(self, document: Document, query: Query) -> float:
        """The <&> operator: negative BM25 score (operators.rs:54)."""
        return -self.evaluate(document, query)
