"""Hybrid engine: cost-based routing between scoring strategies
(counterpart of ``search/hybrid.py``, whose body it copies).

Three execution strategies, one exact result contract:

- **one-shot** (pruned engine, single round): when a query's terms touch
  few (term, range) groups, every candidate range is scored in one pass —
  cost ~ total_ranges x RS, with no dense accumulator and no corpus-sized
  top_k.  The winner for selective queries on large corpora.
- **dense exact**: one fused gather + scatter-add over a [Q, n_docs]
  accumulator + top_k.  Cost ~ n_docs per query regardless of selectivity
  — the winner on small corpora where n_docs is cheap and padding waste
  dominates other strategies.
- **iterative pruned** (Block-Max): bound-ordered chunked rounds with a
  rising threshold — caps the worst case for heavy common-term queries.

The router estimates each query's cost under the strategies from df and
range-count statistics and batches each group separately — the batched
equivalent of serial WAND's per-query adaptivity (the reference processes
one query per backend and adapts naturally; SURVEY.md §2.8).

It holds no kernel of its own: the one-shot and ``pruned`` groups run P1
through the port's ``BlockMaxEngine``, the ``rangescan`` group P1 into one
accumulator and then S2, and everything else the port's ``ExactEngine``
(E1, or E3 with ``memory_mode="compact"``).  A batch is looked up once
(``utils/batchkeys.py::batch_lookup``): the router reads that lookup, and
each group is its rows of it, served through the engines' ids entries.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..index.ranges import RangeIndex, build_range_index, ranges_from_reference
from ..index.sealed import SealedSegment, segment_from_reference
from ..text.intern import Query
from ..utils.batchkeys import batch_lookup, select_rows
from .blockmax import BlockMaxEngine
from .exact import ExactEngine

__all__ = ["HybridEngine"]


class HybridEngine:
    """Routes queries by estimated execution cost."""

    def __init__(
        self,
        segment: SealedSegment,
        range_index: Optional[RangeIndex] = None,
        route_threshold: float = 0.10,
        chunk: Optional[int] = None,
        oneshot_cap: Optional[int] = None,
        device="cuda",
        use_pallas=None,
        memory_mode: str = "fast",
        posting_mode: str = "impact",
        heavy_mode: str = "auto",
    ):
        """memory_mode: "fast" gives the dense strategy its own padded
        [B, 128] block arrays (posting-aligned gathers: ~1 lane/posting
        for selective queries); "compact" shares the pruned engine's
        5 B/posting flat arrays (equal-index-memory mode) at the cost of
        doc-range-aligned gathers whose fill factor drops on selective
        terms, so compact is for memory-constrained deployments only.

        use_pallas: accepted so a reference index's engine options serve
        unchanged, and ignored: the tensors' device picks the kernel."""
        if memory_mode not in ("fast", "compact"):
            raise ValueError(f"unknown memory_mode {memory_mode!r}")
        if heavy_mode not in ("auto", "pruned", "exact", "rangescan"):
            raise ValueError(f"unknown heavy_mode {heavy_mode!r}")
        # df-heavy strategy: "exact" = hand the heavy group to the exact
        # engine (the reference's measured default); "pruned" = the
        # Block-Max round loop (kept selectable: it bounds worst-case
        # *memory* touched and can win on strongly clustered corpora or
        # memory-compact deployments); "rangescan" = exhaustive range
        # sweep through P1 (explicit option only).  "auto" = exact.
        self.heavy_mode = heavy_mode
        if memory_mode == "compact" and posting_mode == "tf":
            raise ValueError(
                "memory_mode='compact' shares impact arrays; use "
                "posting_mode='impact' (or a standalone tf BlockMaxEngine)"
            )
        self.memory_mode = memory_mode
        self.segment = segment
        # The router only needs host-side range metadata; the pruned
        # engine's device arrays (5 B/posting) upload lazily on first
        # use — with the default heavy_mode="exact" they may never be
        # needed at all.
        self.ranges = range_index or build_range_index(segment)
        self._blockmax: Optional[BlockMaxEngine] = None
        self._blockmax_args = dict(
            chunk=chunk,
            device=device,
            use_pallas=use_pallas,
            posting_mode=posting_mode,
        )
        self._term_l = np.diff(self.ranges.token_tr_start)
        self._exact: Optional[ExactEngine] = None
        self._device = device
        self.route_threshold = route_threshold
        # One-shot is taken when its gathered-lane cost (~T x ranges x RS)
        # is clearly below a dense n_docs scan; queries are sub-batched by
        # range-count bucket so small queries don't pay a large query's
        # chunk.
        if oneshot_cap is None:
            # Opt-in, as in the reference: truly selective workloads (rare
            # terms, huge corpora) can enable it explicitly.
            oneshot_cap = 0
        self.oneshot_cap = int(max(0, oneshot_cap))

    @classmethod
    def from_reference(
        cls,
        ref,
        range_index: Optional[RangeIndex] = None,
        device="cuda",
        deleted: Optional[np.ndarray] = None,
        **options,
    ) -> "HybridEngine":
        """Port engine over a copy of a reference HybridEngine's state, or
        over a sealed segment of either package (then ``options`` are the
        constructor's).  Segments and range indexes cross by value; the
        lazy engines are built anew on first use."""
        if range_index is not None:
            range_index = ranges_from_reference(range_index)
        if not hasattr(ref, "segment"):  # a sealed segment
            engine = cls(
                segment_from_reference(ref), range_index, device=device, **options
            )
        else:
            args = ref._blockmax_args
            engine = cls(
                segment_from_reference(ref.segment),
                range_index or ranges_from_reference(ref.ranges),
                route_threshold=ref.route_threshold,
                chunk=args["chunk"],
                oneshot_cap=ref.oneshot_cap,
                device=device,
                use_pallas=args["use_pallas"],
                memory_mode=ref.memory_mode,
                posting_mode=args["posting_mode"],
                heavy_mode=ref.heavy_mode,
            )
            if deleted is None:
                deleted = ref._deleted
        if deleted is not None:
            engine.set_deleted(deleted)
        return engine

    @property
    def blockmax(self) -> BlockMaxEngine:
        if self._blockmax is None:
            self._blockmax = BlockMaxEngine(
                self.segment, self.ranges, **self._blockmax_args
            )
            if self._deleted is not None:
                self._blockmax.set_deleted(self._deleted)
        return self._blockmax

    @property
    def exact(self) -> ExactEngine:
        if self._exact is None:
            if self.memory_mode == "compact":
                # Shares the blockmax engine's device tensors (compact
                # flat postings + doc-live mask): ONE copy of the index
                # on the device — the equal-index-memory mode.
                self._exact = ExactEngine(
                    self.segment, device=self._device, share=self.blockmax
                )
            else:
                self._exact = ExactEngine(self.segment, device=self._device)
                if self._deleted is not None:
                    self._exact.set_deleted(self._deleted)
        return self._exact

    _deleted: Optional[np.ndarray] = None

    def set_deleted(self, deleted: np.ndarray) -> None:
        self._deleted = np.asarray(deleted, dtype=bool)
        if self._blockmax is not None:
            self._blockmax.set_deleted(deleted)
        if self._exact is not None and (
            self._blockmax is None
            or self._exact.dev is not self._blockmax.dev
        ):
            self._exact.set_deleted(deleted)

    def memory_report(self) -> dict:
        """Device bytes of the engines actually constructed (lazy parts
        that were never uploaded cost nothing)."""
        n_post = max(1, int(self.segment.block_n.sum()))
        if self._blockmax is not None:
            rep = dict(self._blockmax.memory_report())
            if (
                self._exact is not None
                and self._exact.dev is not self._blockmax.dev
            ):
                extra = self._exact.memory_report()
                rep["dense_strategy_bytes"] = extra["postings"]
                rep["total"] += extra["postings"]
                rep["bytes_per_posting"] = (
                    rep["total"] - rep["doc_tables"]
                ) / n_post
            return rep
        if self._exact is not None:
            return dict(self._exact.memory_report())
        # Nothing uploaded yet: report the dense engine's size computed
        # host-side (a reporting call must not itself allocate device
        # memory).
        seg = self.segment
        n_rows = -(-n_post // 128)
        postings = (n_rows + 1) * 128 * (4 + 4)  # docid i32 + impact f32
        doc_tables = 4 * (seg.n_docs + 1)
        return {
            "postings": postings,
            "doc_tables": doc_tables,
            "total": postings + doc_tables,
            "bytes_per_posting": postings / n_post,
            "projected": True,  # would-be upload; nothing resident yet
        }

    def _route(
        self, ids: np.ndarray, qidx: np.ndarray, qn: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (strategy [Q] in {0: one-shot, 1: dense, 2: iterative},
        total_ranges [Q]) of a looked-up batch of ``qn`` queries — no
        per-query Python."""
        seg = self.segment
        term_l = self._term_l
        df_budget = max(1.0, self.route_threshold * seg.n_docs)
        ranges = np.zeros(qn, dtype=np.int64)
        dfs = np.zeros(qn, dtype=np.int64)
        if ids.size:
            np.add.at(ranges, qidx, term_l[ids])
            np.add.at(dfs, qidx, seg.token_df[ids])
        # Zero-range queries (all terms OOV / empty) go to the dense
        # group — they return empty cheaply and must not trigger the
        # lazy pruned-engine upload via the one-shot path.
        strategy = np.where(
            (ranges > 0) & (ranges <= self.oneshot_cap),
            np.int8(0),
            np.where(dfs <= df_budget, np.int8(1), np.int8(2)),
        )
        return strategy, ranges

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
        """Dispatch all strategy groups of a batch of ``qn`` queries looked
        up in this engine's token table (``ids``, ``qidx`` as
        ``batch_lookup`` gives them) and return finalize() -> (scores, ids,
        payloads) — groups and successive batches pipeline (their device
        work is enqueued, the host sync waits in finalize)."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        strategy, ranges = self._route(ids, qidx, qn)

        pending = []  # (index array, finalize fn)

        def submit(idx, fn):
            if idx.size:
                pending.append((idx, fn(*select_rows(ids, qidx, qn, idx), idx.size)))

        oneshot = np.flatnonzero(strategy == 0)
        if oneshot.size:
            # Sub-batch by range-count bucket (powers of 4) so a 3-range
            # query never pays a 4096-range query's candidate chunk.
            tr = ranges[oneshot]
            bucket_of = np.zeros(oneshot.size, dtype=np.int64)
            b = 8
            while True:
                mask_above = tr > b
                if not np.any(mask_above):
                    break
                bucket_of[mask_above] += 1
                b *= 4
            for bu in np.unique(bucket_of):
                group = oneshot[bucket_of == bu]
                chunk = 8 * (4 ** int(bu))
                submit(
                    group,
                    lambda *b, c=chunk: self.blockmax.search_ids_async(
                        *b, k, filter_mask, chunk=c
                    ),
                )
        submit(
            np.flatnonzero(strategy == 1),
            lambda *b: self.exact.search_ids_async(*b, k, filter_mask),
        )
        heavy = self.heavy_mode
        if heavy == "auto":
            heavy = "exact"
        heavy_fn = {
            "pruned": lambda *b: self.blockmax.search_ids_async(
                *b, k, filter_mask
            ),
            "exact": lambda *b: self.exact.search_ids_async(
                *b, k, filter_mask
            ),
            "rangescan": lambda *b: self.blockmax.search_rangescan_ids_async(
                *b, k, filter_mask
            ),
        }[heavy]
        submit(np.flatnonzero(strategy == 2), heavy_fn)

        def finalize():
            scores = np.full((qn, k), -np.inf, dtype=np.float32)
            ids = np.full((qn, k), -1, dtype=np.int64)
            payloads = np.full((qn, k), -1, dtype=np.int64)
            for idx, fin in pending:
                s, i, p = fin()
                scores[idx], ids[idx], payloads[idx] = s, i, p
            return scores, ids, payloads

        return finalize

    def search(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.search_async(queries, k, filter_mask)()
