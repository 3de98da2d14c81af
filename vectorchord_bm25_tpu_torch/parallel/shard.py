"""Doc-sharded index on one card (counterpart of ``parallel/shard.py``):
doc-sharded build, search and mutation over shards stacked along a
leading tensor dimension.

The reference runs one shard a mesh device: every ``shard_put`` array is
split over the mesh axis, each search body runs under ``shard_map``, and
the per-shard top-k candidates meet through ``all_gather`` and one
lexicographic sort.  On one card the mesh becomes the leading dimension:

- every per-shard array is one ``[D, ...]`` tensor on the index's device,
  each shard's row contiguous, so the existing kernels (S1-S5, E1, E3, B1,
  P1, P1-tf, S2) run on shard ``i``'s row as they run on one segment's
  tables;
- each ``shard_map`` body becomes a loop over the shards whose local top-k
  producers (S2, Block-Max's running top-k) write each shard's sorted
  ``[Q, w]`` scores and local ids straight into its slice of one stacked
  ``[D, Q, w]`` pair, and the rebase to global ids (``INT_MAX`` where the
  score is not finite), the ``all_gather`` and ``lax.sort((-s, id),
  num_keys=2)`` become one SH-merge launch that merges the sorted runs
  (``ops/shard_kernels.py:shard_merge``), given each shard's width and the
  doc offsets uploaded with the index;
- a ``psum`` becomes a sum over the leading dimension
  (``global_stats_step``, through SH-stats).

The semantics stay the reference's: per-shard sealed segments,
offset-rebased global doc ids, global (N, sum dl, df) statistics baked
into every shard's impacts, the (score desc, doc asc) merge, and the
growing segment, deletes, maintain and persistence of the single index.
The numpy planning, the mutations and the MaxScore tiers are copies of the
reference's; the bodies that reached jax are rewritten.  Where a body needs
a term ordinal that the sharded planning does not compute (S1's, E1's and
E3's adds run one term ordinal at a time), it is derived on the host the
way the single-segment engines derive it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.growing import GrowingSegment
from ..index.sealed import (
    BLOCK,
    SealedSegment,
    build_sealed_segment,
    build_sealed_segment_from_postings,
    segment_from_reference,
)
from ..models.scoring import ScoreTables, idf
from ..ops.exact_kernel import exact_compact_accumulate, exact_dense_accumulate
from ..ops.shard_kernels import shard_merge, shard_stats
from ..ops.stream_kernel import stream_dense_accumulate
from ..ops.stream_rescore import rescore_topk
from ..ops.stream_sparse import doc_ordered, segment_offsets, stream_sparse_topk
from ..ops.topk import dense_topk
from ..search.blockmax import _blockmax_kernel
from ..search.stream import (
    StreamEngine,
    _ms_certify,
    _ms_prefix_prep,
    routes_maxscore,
    window_ordinals,
)
from ..text.intern import WIDTH, Document, Query, random_seed
from ..utils.batchkeys import batch_lookup, group_positions
from ..utils.buckets import bucket_pow2 as _bucket
from ..utils.device import as_device
from ..utils.options import IndexOptions, SearchOptions, SessionConfig
from ..utils.rwlock import RWLock

__all__ = ["ShardedIndex"]

_INT_MAX = np.int32(np.iinfo(np.int32).max)
_NEG_INF_BITS = int(np.array(-np.inf, dtype=np.float32).view(np.int32))


@dataclass
class _ShardView:
    """Host-side per-shard lookup state."""

    segment: SealedSegment
    doc_offset: int
    # global token id -> local token id (-1 when the shard lacks the term)
    local_tid: np.ndarray


class _GlobalStats:
    """Sealed-segment-shaped view of the sharded index's global statistics.

    The growing segment scores inserted docs against the *sealed*
    statistics (search.rs:53-79); for a sharded index those are the
    merged global (N, sum dl, df) — this adapter exposes exactly the
    interface GrowingSegment reads.
    """

    def __init__(self, index: "ShardedIndex"):
        self._ix = index

    @property
    def n_docs(self) -> int:
        return self._ix.n_docs

    @property
    def sum_dl(self) -> int:
        return self._ix.sum_dl

    @property
    def options(self) -> IndexOptions:
        return self._ix.options

    def lookup_tokens(self, keys: np.ndarray) -> np.ndarray:
        return self._ix.lookup_tokens(keys)

    def score_tables(self) -> ScoreTables:
        return self._ix.tables

    def token_s0(self) -> np.ndarray:
        return self._ix.token_s0


class ShardedIndex:
    """Doc-sharded BM25 index, its shards stacked on one device.

    Build: corpus split into contiguous shards; each shard is a sealed
    segment; global stats (N, sum dl, df) are merged so scoring matches the
    single-segment build exactly.  Engines: "stream" (compressed posting
    stream, dense or MaxScore per shard), "exact" (dense block arrays),
    "blockmax" (pruned flat postings), "hybrid" (per-query routing over
    the exact strategy's arrays, or the compact range-aligned ones).
    """

    def __init__(
        self,
        shards: List[SealedSegment],
        options: IndexOptions,
        device="cuda",
        axis: str = "d",
        engine: str = "stream",
        seed: Optional[bytes] = None,
        search_options: Optional[SearchOptions] = None,
        posting_mode: str = "impact",
        memory_mode: str = "fast",
        strategy: str = "auto",
    ):
        if engine not in ("exact", "blockmax", "hybrid", "stream"):
            raise ValueError(f"unknown engine {engine!r}")
        if strategy not in ("auto", "dense", "maxscore"):
            raise ValueError(f"unknown strategy {strategy!r}")
        # Stream-engine reduction strategy: "dense" is the flat scatter-add
        # path; "maxscore" prunes per shard with tiered exactness
        # certification (each shard certifies its LOCAL top-k
        # independently — doc-sharding keeps every doc's score within one
        # shard); "auto" routes like the single-segment StreamEngine.
        self.strategy = strategy
        if memory_mode not in ("fast", "compact"):
            raise ValueError(f"unknown memory_mode {memory_mode!r}")
        # "fast": the hybrid's dense strategy reads posting-aligned flat
        # rows; "compact" reuses the pruned engine's doc-range-aligned
        # stream (one copy of the postings on the device).
        self.memory_mode = memory_mode
        #: work profile of the last sharded maxscore dispatch (None
        #: before one) — same shape as StreamEngine.last_ms_stats.
        self.last_ms_stats = None
        if posting_mode not in ("impact", "tf"):
            raise ValueError(f"unknown posting_mode {posting_mode!r}")
        if posting_mode == "tf" and engine != "blockmax":
            raise ValueError(
                "posting_mode='tf' requires engine='blockmax' (the dense "
                "strategies read impact arrays)"
            )
        self.posting_mode = posting_mode
        self.options = options
        self.search_options = search_options or SearchOptions()
        # The reference's mesh axis name: kept for the on-disk meta.
        self.axis = axis
        self.engine = engine
        self.seed = seed if seed is not None else random_seed()
        self.device = as_device(device)
        # Concurrency discipline mirrors Bm25Index (the reference's
        # lock-page protocol): searches/point mutations share the RW
        # lock, maintain takes it exclusive for the generation swap.
        self._rw = RWLock()
        self._mutex = threading.RLock()
        self._init_from_shards(shards)
        self.deleted = np.zeros(self.n_docs, dtype=bool)
        self._deleted_dirty = False
        self.growing = GrowingSegment(_GlobalStats(self), device=self.device)
        # Optional write-ahead log (storage.Wal): mutations are fsynced
        # before acknowledgement (the GenericXLog analog), replayed by
        # open_sharded_index after a crash.
        self._wal = None

    def attach_wal(self, wal) -> None:
        self._wal = wal

    @classmethod
    def from_reference(cls, ref, device="cuda") -> "ShardedIndex":
        """Port index over a copy of a reference ``ShardedIndex``'s host
        state: its shards' segments, delete bitmap, growing segment, seed,
        options and engine options, all by value."""
        so = ref.search_options
        index = cls(
            [segment_from_reference(v.segment) for v in ref.views],
            IndexOptions(k1=ref.options.k1, b=ref.options.b),
            device=device,
            axis=ref.axis,
            engine=ref.engine,
            seed=bytes(ref.seed),
            search_options=SearchOptions(limit=so.limit, prefilter=so.prefilter),
            posting_mode=ref.posting_mode,
            memory_mode=ref.memory_mode,
            strategy=ref.strategy,
        )
        deleted = np.array(ref.deleted, dtype=bool)
        if deleted.any():
            index.set_deleted(deleted)
        for doc, payload in zip(ref.growing.documents, ref.growing.payloads):
            index.growing.insert(Document(keys=doc.keys, values=doc.values), payload)
        index.growing.apply_delete_mask(np.array(ref.growing.deleted, dtype=bool))
        return index

    # ------------------------------------------------------------------
    def _init_from_shards(self, shards: List[SealedSegment]) -> None:
        self.n_shards = len(shards)
        if self.n_shards < 1:
            raise ValueError("a sharded index needs at least one shard")

        # Global stats (the reference's single jump tuple).
        self.n_docs = sum(s.n_docs for s in shards)
        self.sum_dl = sum(s.sum_dl for s in shards)
        offsets = np.cumsum([0] + [s.n_docs for s in shards])[:-1]

        # Global token table: union of shard vocabularies, df summed.
        all_keys = np.concatenate(
            [s.token_keys for s in shards]
        ).astype(f"S{WIDTH}")
        self.token_keys = np.unique(all_keys)  # sorted unique
        vg = self.token_keys.size
        self.token_df = np.zeros(vg, dtype=np.int64)
        self.views: List[_ShardView] = []
        for s, off in zip(shards, offsets):
            gid = np.searchsorted(self.token_keys, s.token_keys)
            self.token_df[gid] += s.token_df
            local = np.full(vg, -1, dtype=np.int64)
            local[gid] = np.arange(s.n_tokens)
            self.views.append(
                _ShardView(segment=s, doc_offset=int(off), local_tid=local)
            )

        self.tables = ScoreTables.create(
            self.options.k1, self.options.b, self.n_docs, self.sum_dl
        )
        self.token_s0 = idf(self.n_docs, self.token_df) * (
            self.options.k1 + 1.0
        )

        self._ms_tables = None
        self._upload()
        if self.engine in ("blockmax", "hybrid"):
            self._upload_blockmax()
        elif self.engine == "stream":
            self._upload_stream()

    def lookup_tokens(self, keys: np.ndarray) -> np.ndarray:
        """Global token ids for 16-byte keys; missing -> -1."""
        keys = np.asarray(keys, dtype=f"S{WIDTH}")
        if self.token_keys.size == 0:
            return np.full(keys.shape, -1, dtype=np.int64)
        idxs = np.searchsorted(self.token_keys, keys)
        idxs = np.minimum(idxs, self.token_keys.size - 1)
        found = self.token_keys[idxs] == keys
        return np.where(found, idxs, -1)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        documents: Sequence[Document],
        n_shards: int,
        payloads: Optional[Sequence[int]] = None,
        options: Optional[IndexOptions] = None,
        device="cuda",
        engine: str = "stream",
        seed: Optional[bytes] = None,
        device_build: Optional[bool] = None,
        posting_mode: str = "impact",
        strategy: str = "auto",
    ) -> "ShardedIndex":
        """Data-parallel build: contiguous corpus shards, offset-rebased
        doc ids (io.rs:244-282 analog), served on ``device``.

        device_build=True sorts every shard's postings on ``device`` in one
        launch and scans the doc offsets there (parallel/devbuild.py) — the
        am_build.rs:353-527 analog; False builds each shard on the host.
        Both produce bit-identical segments.  Default (None): the device
        build whenever there are two shards or more — the reference builds
        on its mesh whenever one device per shard exists, and on one card
        the stacked shards are that mesh.
        """
        options = options or IndexOptions()
        n = len(documents)
        if payloads is None:
            payloads = np.arange(n, dtype=np.int64)
        payloads = np.asarray(payloads, dtype=np.int64)
        bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
        if device_build is None:
            device_build = n_shards >= 2
        if device_build:
            from .devbuild import build_shards_on_device

            shards = build_shards_on_device(
                documents, bounds, payloads, options, device=device
            )
        else:
            shards = []
            for i in range(n_shards):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                shards.append(
                    build_sealed_segment(
                        list(documents[lo:hi]),
                        payloads=payloads[lo:hi],
                        options=options,
                    )
                )
        return cls(
            shards, options, device=device, engine=engine, seed=seed,
            posting_mode=posting_mode, strategy=strategy,
        )

    @classmethod
    def build_from_postings(
        cls,
        keys: np.ndarray,
        doc_ids: np.ndarray,
        tfs: np.ndarray,
        doc_start: np.ndarray,
        n_shards: int,
        payloads: Optional[Sequence[int]] = None,
        options: Optional[IndexOptions] = None,
        device="cuda",
        engine: str = "stream",
        seed: Optional[bytes] = None,
        device_build: Optional[bool] = None,
        posting_mode: str = "impact",
        strategy: str = "auto",
    ) -> "ShardedIndex":
        """`build` for flat doc-grouped postings (keys [P] |S16, doc_ids
        [P] ascending, tfs [P], doc_start [N+1] CSR) — the scale path
        with no per-document Python objects, mirroring the reference's
        heap-tuple scan feeding the parallel build."""
        options = options or IndexOptions()
        doc_start = np.asarray(doc_start, dtype=np.int64)
        n = doc_start.size - 1
        if payloads is None:
            payloads = np.arange(n, dtype=np.int64)
        payloads = np.asarray(payloads, dtype=np.int64)
        bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
        if device_build is None:
            device_build = n_shards >= 2
        if device_build:
            from .devbuild import build_shards_on_device_from_postings

            shards = build_shards_on_device_from_postings(
                keys, doc_ids, tfs, doc_start, bounds, payloads,
                options, device=device,
            )
        else:
            doc_ids = np.asarray(doc_ids, dtype=np.int64)
            shards = []
            for i in range(n_shards):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                p0, p1 = int(doc_start[lo]), int(doc_start[hi])
                shards.append(
                    build_sealed_segment_from_postings(
                        np.asarray(keys[p0:p1], dtype=f"S{WIDTH}"),
                        doc_ids[p0:p1] - lo,
                        np.asarray(tfs[p0:p1], dtype=np.int64),
                        hi - lo,
                        payloads=payloads[lo:hi],
                        options=options,
                        doc_grouped=True,
                    )
                )
        return cls(
            shards, options, device=device, engine=engine, seed=seed,
            posting_mode=posting_mode, strategy=strategy,
        )

    # ------------------------------------------------------------------
    def _put(self, x: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the index's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _upload(self):
        """Stack per-shard arrays (padded to uniform shape) along a leading
        shard dimension on the device."""
        shards = [v.segment for v in self.views]
        d = self.n_shards
        nmax = max(max((s.n_docs for s in shards), default=1), 1)
        bmax = max(max((s.n_blocks for s in shards), default=1), 1)

        doc_fn = np.zeros((d, nmax + 1), dtype=np.uint8)
        doc_live = np.zeros((d, nmax + 1), dtype=np.float32)
        n_local = np.zeros(d, dtype=np.int64)

        # Dense engine storage: each shard's flat (token, doc)-ordered
        # posting stream with global-stats impacts, reshaped to 128-lane
        # rows (zero padding between terms; see search/device.py).
        with_blocks = self.engine == "exact" or (
            self.engine == "hybrid" and self.memory_mode == "fast"
        )
        if with_blocks:
            flats = []
            rpmax = 1
            for view in self.views:
                s = view.segment
                gid = np.searchsorted(self.token_keys, s.token_keys)
                docid, impact, csr = s.flat_impact_postings(
                    global_stats=(
                        self.n_docs, self.sum_dl, self.token_s0[gid]
                    )
                )
                flats.append((docid, impact, csr))
                rpmax = max(rpmax, -(-max(docid.size, 1) // BLOCK))
            self._flat_csr = [f[2] for f in flats]
            self._rpmax = rpmax
            post_docid = np.full(
                (d, rpmax + 1, BLOCK), nmax, dtype=np.int32
            )
            post_impact = np.zeros((d, rpmax + 1, BLOCK), dtype=np.float32)
            for i, (docid, impact, _) in enumerate(flats):
                t = docid.size
                pd_flat = post_docid[i].reshape(-1)
                pi_flat = post_impact[i].reshape(-1)
                # Local doc ids < n_i stay; pad lanes use the dead slot.
                pd_flat[:t] = docid
                pi_flat[:t] = impact
        else:
            post_docid = post_impact = None
            self._flat_csr = None
            self._rpmax = 0

        for i, view in enumerate(self.views):
            s = view.segment
            n = s.n_docs
            doc_fn[i, :n] = s.doc_fieldnorm
            doc_live[i, :n] = 1.0
            n_local[i] = n

        # Host-side payload mapping (the device returns global doc ids;
        # payloads stay int64 on the host).
        self.global_payloads = np.concatenate(
            [v.segment.doc_payload for v in self.views]
        ) if self.n_docs else np.zeros(0, dtype=np.int64)

        put = self._put
        self._nmax = nmax
        self._bmax = bmax
        self.doc_offsets = np.array(
            [v.doc_offset for v in self.views], dtype=np.int64
        )
        self.dev_doc_offsets = put(self.doc_offsets)  # SH-merge's rebase
        self.dev_doc_fn = put(doc_fn)
        self.dev_doc_live = put(doc_live)
        self.dev_post_docid = put(post_docid) if with_blocks else None
        self.dev_post_impact = put(post_impact) if with_blocks else None
        self.dev_n_local = put(n_local)
        self.dev_s1 = put(self.tables.s1_table.astype(np.float32))
        self._dev_ones = put(np.ones((d, nmax + 1), dtype=np.float32))

    # ------------------------------------------------------------------
    def _shard_doc_array(self, values: np.ndarray, fill=0.0) -> np.ndarray:
        """Scatter a global per-doc array into the stacked per-shard
        [d, nmax+1] layout."""
        d = self.n_shards
        out = np.full((d, self._nmax + 1), fill, dtype=np.float32)
        for i, view in enumerate(self.views):
            n = view.segment.n_docs
            off = view.doc_offset
            out[i, :n] = values[off : off + n]
        return out

    def _refresh_deleted(self) -> None:
        live = self._shard_doc_array(
            np.where(self.deleted, 0.0, 1.0), fill=0.0
        )
        self.dev_doc_live = self._put(live)
        self._deleted_dirty = False

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Refresh the live mask from a global-doc-id delete bitmap (the
        raw-bitmap bulkdelete path; consulted at scoring)."""
        deleted = np.asarray(deleted, dtype=bool)
        if deleted.shape != (self.n_docs,):
            raise ValueError("bitmap must cover all global doc ids")
        with self._mutex:
            self.deleted = deleted.copy()
            self._refresh_deleted()

    # ------------------------------------------------------------------
    # Mutations (the aminsert / ambulkdelete / amvacuumcleanup surface).
    # ------------------------------------------------------------------
    def insert(self, document: Document, payload: int) -> None:
        """Append to the growing segment; visible to search immediately,
        scored with the global sealed statistics (insert.rs analog)."""
        with self._rw.read(), self._mutex:
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
        """Mark docs whose payload matches; returns count marked.
        Vectorized over the global payload array (bulkdelete.rs analog)."""
        from ..index.bm25index import _eval_predicate

        with self._rw.read(), self._mutex:
            mask = _eval_predicate(predicate, self.global_payloads)
            g_mask = _eval_predicate(
                predicate, np.asarray(self.growing.payloads, dtype=np.int64)
            )
            return self._bulkdelete_masks(mask, g_mask)

    def bulkdelete_payloads(self, payloads) -> int:
        """Delete by explicit payload set (np.isin fast path)."""
        targets = np.asarray(
            list(payloads)
            if not isinstance(payloads, np.ndarray)
            else payloads,
            dtype=np.int64,
        )
        with self._rw.read(), self._mutex:
            mask = np.isin(self.global_payloads, targets)
            g_mask = np.isin(
                np.asarray(self.growing.payloads, dtype=np.int64), targets
            )
            return self._bulkdelete_masks(mask, g_mask)

    def _bulkdelete_masks(self, sealed_mask, growing_mask) -> int:
        newly = sealed_mask & ~self.deleted
        count = int(newly.sum())
        if count:
            self.deleted |= newly
            self._deleted_dirty = True
        g_dead = np.asarray(self.growing.deleted, dtype=bool)
        g_newly = (
            growing_mask & ~g_dead
            if g_dead.size
            else np.zeros(0, dtype=bool)
        )
        total = count + self.growing.apply_delete_mask(g_newly)
        if total and self._wal is not None:
            self._wal.append(
                {
                    "op": "delete",
                    "sealed": np.flatnonzero(newly).tolist(),
                    "growing": np.flatnonzero(g_newly).tolist(),
                }
            )
        return total

    @property
    def n_live(self) -> int:
        """Live documents across sealed shards + growing."""
        return int((~self.deleted).sum()) + self.growing.n_live

    def maintain(self) -> None:
        """Merge/compaction (maintain.rs semantics, sharded): relabel live
        docs — sealed shard order then growing insertion order — re-split
        into fresh contiguous shards, and swap the device generation."""
        with self._rw.write():
            self._maintain_locked()
            if self._wal is not None:
                self._wal.append({"op": "maintain"})

    def _maintain_locked(self) -> None:
        live = ~self.deleted
        n_live_sealed = int(live.sum())
        new_id = np.cumsum(live, dtype=np.int64) - 1  # valid where live

        # Pass A+B: surviving sealed postings from every shard, mapped to
        # global token ids and relabeled global doc ids.
        tid_parts, doc_parts, tf_parts = [], [], []
        for view in self.views:
            s = view.segment
            if not (s.n_docs and s.n_blocks):
                continue
            tok, doc, tfv = s.postings()
            gid_map = np.searchsorted(self.token_keys, s.token_keys)
            gdoc = doc.astype(np.int64) + view.doc_offset
            keep = live[gdoc]
            tid_parts.append(gid_map[tok[keep]].astype(np.int64))
            doc_parts.append(new_id[gdoc[keep]])
            tf_parts.append(tfv[keep].astype(np.int64))
        if tid_parts:
            s_tid = np.concatenate(tid_parts)
            s_doc = np.concatenate(doc_parts)
            s_tf = np.concatenate(tf_parts)
        else:
            s_tid = np.zeros(0, dtype=np.int64)
            s_doc = np.zeros(0, dtype=np.int64)
            s_tf = np.zeros(0, dtype=np.int64)
        payloads = self.global_payloads[live]

        # Pass C: live growing docs (global vocab union if they add terms).
        vocab = self.token_keys
        g_live = [i for i, d in enumerate(self.growing.deleted) if not d]
        n_new = n_live_sealed + len(g_live)
        if g_live:
            g_docs = [self.growing.documents[i] for i in g_live]
            g_counts = np.fromiter(
                (len(d) for d in g_docs), dtype=np.int64, count=len(g_docs)
            )
            g_keys = (
                np.concatenate([d.keys for d in g_docs])
                if int(g_counts.sum())
                else np.zeros(0, dtype=f"S{WIDTH}")
            )
            g_tf = (
                np.concatenate([d.values for d in g_docs]).astype(np.int64)
                if int(g_counts.sum())
                else np.zeros(0, dtype=np.int64)
            )
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
                vocab = np.union1d(self.token_keys, g_keys)
                if self.token_keys.size:
                    s_tid = np.searchsorted(vocab, self.token_keys)[s_tid]
                g_tid = np.searchsorted(vocab, g_keys)
                s_tid = np.concatenate([s_tid, g_tid])
                s_doc = np.concatenate([s_doc, g_doc])
                s_tf = np.concatenate([s_tf, g_tf])

        # One packed u64 sort restores global (token, doc) order (shard
        # streams interleave per token).
        if s_tid.size:
            packed = (s_tid.astype(np.uint64) << np.uint64(32)) | s_doc.astype(
                np.uint64
            )
            order = np.argsort(packed)
            s_tid, s_doc, s_tf = s_tid[order], s_doc[order], s_tf[order]

        # Re-split into contiguous shards; per-shard selection of the
        # (token, doc)-sorted stream stays (token, local doc) sorted.
        bounds = np.linspace(0, n_new, self.n_shards + 1).astype(np.int64)
        shards = []
        for i in range(self.n_shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            mask = (s_doc >= lo) & (s_doc < hi)
            shards.append(
                build_sealed_segment_from_postings(
                    None,
                    s_doc[mask] - lo,
                    s_tf[mask],
                    hi - lo,
                    payloads=payloads[lo:hi],
                    options=self.options,
                    presorted=True,
                    token_ids=s_tid[mask],
                    vocab_keys=vocab,
                )
            )
        # Atomic generation swap: fresh shards, device arrays, stats.
        self._init_from_shards(shards)
        self.deleted = np.zeros(self.n_docs, dtype=bool)
        self._deleted_dirty = False
        self.growing = GrowingSegment(_GlobalStats(self), device=self.device)

    # ------------------------------------------------------------------
    def evaluate(self, document: Document, query: Query) -> float:
        """Exact BM25 score of one (document, query) pair under the global
        statistics (evaluate.rs:22-74)."""
        from ..models.fieldnorm import length_to_fieldnorm
        from ..models.scoring import tf as tf_fn

        if self.n_docs == 0:
            return 0.0
        fieldnorm = int(length_to_fieldnorm(document.length()))
        avgdl = self.sum_dl / self.n_docs if self.n_docs else 1.0
        tids = self.lookup_tokens(document.keys)
        q_tids = set(int(t) for t in self.lookup_tokens(query.keys) if t >= 0)
        total = 0.0
        for t, v in zip(tids, document.values):
            t = int(t)
            if t < 0 or t not in q_tids:
                continue
            total += float(
                idf(self.n_docs, int(self.token_df[t]))
                * tf_fn(
                    fieldnorm, int(v), self.options.k1, self.options.b, avgdl
                )
            )
        return total

    def operator_score(self, document: Document, query: Query) -> float:
        """The <&> operator: negative BM25 score (operators.rs:54)."""
        return -self.evaluate(document, query)

    # ------------------------------------------------------------------
    # The per-shard local top-ks and their merge (SH-merge).
    # ------------------------------------------------------------------
    def _runs(self, q: int, w: int, pads: bool = False):
        """The stacked [D, q, w] (scores, local ids) pair each shard's local
        top-k is written into, SH-merge's input: one int32 allocation whose
        first plane holds the scores' f32 bits.  ``pads``: filled with
        (-inf, INT_MAX), as Block-Max's running top-k starts; else left
        unset (SH-merge reads a shard's slots only up to its width)."""
        buf = torch.empty((2, self.n_shards, q, w), dtype=torch.int32, device=self.device)
        if pads:
            buf[0].fill_(_NEG_INF_BITS)
            buf[1].fill_(int(_INT_MAX))
        return buf[0].view(torch.float32), buf[1]

    def _dense_local(self, acc, runs, si: int) -> None:
        """The dense bodies' local top-k (S2) of one shard's accumulator,
        written by S2 straight into the shard's slice of ``runs``.  Their
        width is min(kk, nmax): past the shard's slot count (kk > nmax: tiny
        shards) SH-merge pads the merged row, as the reference's padded
        ``top_k`` does."""
        s, i = runs
        dense_topk(acc, s.shape[2], self._nmax, out=(s[si], i[si]))

    def _merged(self, runs, widths, kk: int):
        """SH-merge of the shards' runs (``widths[d]`` slots of shard d's
        rows), as host arrays [q, kk] of scores and global ids: one launch
        and one copy to the host."""
        out = shard_merge(*runs, widths, self.dev_doc_offsets, kk).cpu().numpy()
        return out[0].view(np.float32), out[1].astype(np.int64)

    # ------------------------------------------------------------------
    def _upload_stream(self):
        """Stack per-shard delta-compressed posting streams (padded) along
        the shard dimension — the equal-index-memory serving layout
        (index/stream.py).  Global statistics are baked into per-shard
        s0/impact bounds so sharded scores match the single-segment stream
        bit-for-bit."""
        from ..index.stream import build_stream_index

        streams = []
        for view in self.views:
            s = view.segment
            gid = np.searchsorted(self.token_keys, s.token_keys)
            streams.append(
                build_stream_index(
                    s,
                    global_stats=(
                        self.n_docs,
                        self.sum_dl,
                        self.token_s0[gid],
                    ),
                )
            )
        self._streams = streams
        d = self.n_shards
        nmax = self._nmax
        smax = max(st.words.size for st in streams)
        wmax = max(st.n_windows for st in streams)
        self._swmax = wmax  # pad window id (per shard: its zero tail)

        words = np.zeros((d, smax), dtype=np.uint32)
        w_off = np.zeros((d, wmax + 1), dtype=np.int32)
        w_base = np.zeros((d, wmax + 1), dtype=np.int32)
        w_meta = np.zeros((d, wmax + 1), dtype=np.uint16)
        w_s0 = np.zeros((d, wmax + 1), dtype=np.float32)
        # Fused per-doc s1 table (search/stream.py): s1[fieldnorm[d]]
        # with +inf at deleted docs, pad slots, and cross-shard tails —
        # scores collapse to exactly 0.0 through ONE per-lane gather.
        s1bd = np.full((d, nmax + 1), np.inf, dtype=np.float32)
        for i, st in enumerate(streams):
            words[i, : st.words.size] = st.words
            w = st.n_windows
            w_off[i, :w] = st.w_off4
            w_base[i, :w] = st.w_base
            w_meta[i, :w] = st.w_meta16()
            w_s0[i, :w] = st.w_s0
            # Pad windows: zero length, offset at the shard's zero tail.
            w_off[i, w:] = st.words.size - 64
            fn = st.doc_fn[: st.n_docs]
            s1bd[i, : st.n_docs] = np.where(
                fn < 256, st.s1_table[fn & 0xFF], np.inf
            ).astype(np.float32)

        put = self._put
        # u32 words and u16 meta as the same bits in int32 / int16, as the
        # stream kernels take them.
        self.dev_st_words = put(words.view(np.int32))
        self.dev_st_w_off = put(w_off)
        self.dev_st_w_base = put(w_base)
        self.dev_st_w_meta = put(w_meta.view(np.int16))
        self.dev_st_w_s0 = put(w_s0)
        self.dev_st_s1bd = put(s1bd)

    def _stream_tables(self, si: int):
        return (
            self.dev_st_words[si],
            self.dev_st_w_off[si],
            self.dev_st_w_base[si],
            self.dev_st_w_meta[si],
            self.dev_st_w_s0[si],
        )

    def _stream_s1_eff(self, fmask_dev):
        """[D, nmax+1] fused s1 tables with dead and filtered docs at +inf
        (dead/filtered lanes score exactly 0.0)."""
        return torch.where(
            (self.dev_doc_live * fmask_dev) > 0.0, self.dev_st_s1bd, float("inf")
        )

    def _prepare_stream(self, queries: Sequence[Query]):
        """Per-shard flat window-id lists for a replicated query batch:
        (wsrc, q_of) per shard, query-ascending."""
        g_all, q_all = batch_lookup(self.lookup_tokens, queries)
        per_shard = []
        for view, stm in zip(self.views, self._streams):
            lids = view.local_tid[g_all] if g_all.size else g_all
            ok = lids >= 0
            lt, qt = lids[ok], q_all[ok]
            tws = stm.token_w_start
            if lt.size:
                los = tws[lt]
                cnt = tws[lt + 1] - los
                wsrc = (np.repeat(los, cnt) + group_positions(cnt)).astype(
                    np.int64
                )
                q_of = np.repeat(qt, cnt)
            else:
                wsrc = np.zeros(0, dtype=np.int64)
                q_of = np.zeros(0, dtype=np.int64)
            per_shard.append((wsrc, q_of))
        return per_shard

    def _search_stream(
        self,
        queries: Sequence[Query],
        k: int,
        fmask_dev,
        skip_pairs: Optional[np.ndarray] = None,
    ):
        """Equal-index-memory sharded search: per shard, the flat window
        dispatch of the stream's dense path (S1, then S2), then SH-merge.

        skip_pairs [d, qn] bool: (shard, query) pairs whose windows are
        dropped from the dispatch — the MaxScore per-shard fallback
        passes the certified pairs here (their exact local top-ks are
        already known), so only uncertified shards rescan and the merge
        covers exactly the rescanned shards."""
        qn = len(queries)
        per_shard = self._prepare_stream(queries)
        if skip_pairs is not None:
            per_shard = [
                (ws[~skip_pairs[si, q_of]], q_of[~skip_pairs[si, q_of]])
                for si, (ws, q_of) in enumerate(per_shard)
            ]
        kk = _bucket(k, 1)
        nmax = self._nmax
        width = min(kk, nmax)
        s1_eff = self._stream_s1_eff(fmask_dev)

        # Sub-batch queries so each shard's [q, nmax+1] accumulator
        # stays under the budget (and int32 flat-scatter addressing).
        q_cap = max(1, (1 << 30) // (4 * (nmax + 1)))
        while q_cap * (nmax + 1) >= 1 << 31:
            q_cap //= 2
        scores = np.full((qn, kk), -np.inf, dtype=np.float32)
        gids = np.full((qn, kk), np.iinfo(np.int32).max, dtype=np.int64)
        starts = [
            np.searchsorted(q_of, np.arange(qn + 1))
            for _, q_of in per_shard
        ]
        for q0 in range(0, qn, q_cap):
            q1 = min(qn, q0 + q_cap)
            nq = q1 - q0
            runs = self._runs(nq, width)
            widths = [0] * self.n_shards
            for si, ((ws, q_of), st) in enumerate(zip(per_shard, starts)):
                lo, hi = int(st[q0]), int(st[q1])
                if hi == lo:
                    continue  # no window: the shard offers no candidate
                wsrc = ws[lo:hi]
                wq = q_of[lo:hi] - q0
                sizes = np.bincount(wq, minlength=nq).astype(np.int64)
                q_starts = np.concatenate(([0], np.cumsum(sizes)))
                word_ord = window_ordinals(self._streams[si], wsrc, q_starts, sizes)
                words, w_off, w_base, w_meta, w_s0 = self._stream_tables(si)
                acc = stream_dense_accumulate(
                    words, s1_eff[si], w_off, w_base, w_meta, w_s0,
                    *(self._put(x.astype(np.int32)) for x in (wsrc, q_starts, word_ord)),
                    nq, nmax,
                )
                self._dense_local(acc, runs, si)
                widths[si] = width
                del acc
            s, i = self._merged(runs, widths, kk)
            scores[q0:q1] = s
            gids[q0:q1] = i
        return scores[:, :k], gids[:, :k]

    # ------------------------------------------------------------------
    def _ms_shard_tables(self):
        """Per-shard impact-descending window order + (f64) bounds —
        the sharded analog of StreamEngine._maxscore_tables."""
        if self._ms_tables is None:
            tabs = []
            for st in self._streams:
                order = np.lexsort((-st.w_maximp, st.w_token)).astype(
                    np.int64
                )
                tabs.append(
                    (order, st.w_maximp[order].astype(np.float64))
                )
            self._ms_tables = tabs
        return self._ms_tables

    def _search_stream_ms(self, queries: Sequence[Query], k: int, fmask_dev):
        """Pruned sharded search (strategy='maxscore'): per-shard
        MaxScore with tiered exactness certification.

        Doc-sharding keeps every document's full score within one
        shard, so the problem decomposes: each shard certifies its
        LOCAL top-k independently (same tiers/bounds as the single-chip
        StreamEngine._ms_tier), the certified per-shard top-ks merge by
        (score desc, id asc), and any query with an uncertified shard
        falls back to the exhaustive sharded scan (_search_stream).
        Each shard's pool is one sparse dispatch (S3, S4) and its
        candidates one rescore (S5), on the shard's rows."""
        qn = len(queries)
        d = self.n_shards
        nmax = self._nmax
        scores_out = np.full((qn, k), -np.inf, dtype=np.float32)
        gids_out = np.full((qn, k), _INT_MAX, dtype=np.int64)
        g_all, q_all = batch_lookup(self.lookup_tokens, queries)
        if g_all.size == 0:
            return scores_out, gids_out

        s1_eff = self._stream_s1_eff(fmask_dev)
        tabs = self._ms_shard_tables()
        shard_terms = []
        for view in self.views:
            lids = view.local_tid[g_all]
            ok = lids >= 0
            shard_terms.append((lids[ok], q_all[ok]))
        doc_offsets = self.doc_offsets

        # Per-query routing for strategy='auto' (same predicted-work
        # rule as StreamEngine._ms_route, summed across shards): only
        # queries whose tier-1 prefixes keep a small fraction of a
        # large window set take the pruned tiers — the rest go
        # straight to the exhaustive sharded scan.
        routed_mask = np.ones(qn, dtype=bool)
        if self.strategy == "auto":
            tau1 = StreamEngine.MS_TIERS[0][0]
            tot = np.zeros(qn, dtype=np.float64)
            ph1 = np.zeros(qn, dtype=np.float64)
            for si in range(d):
                lids, qs = shard_terms[si]
                order, bounds = tabs[si]
                tws = self._streams[si].token_w_start
                lo, hi, cut, _, _ = _ms_prefix_prep(
                    order, bounds, tws, lids, qs, qn, tau1, 0.0
                )
                tot += np.bincount(
                    qs, weights=(hi - lo).astype(np.float64),
                    minlength=qn,
                )
                ph1 += np.bincount(
                    qs, weights=cut.astype(np.float64), minlength=qn
                )
            frac = np.where(tot > 0, ph1 / np.maximum(tot, 1.0), 1.0)
            routed_mask = (
                tot >= StreamEngine.MS_ROUTE_MIN_WINDOWS
            ) & (frac <= StreamEngine.MS_ROUTE_FRAC)
        not_routed = np.flatnonzero(~routed_mask).astype(np.int64)

        res_s = np.full((d, qn, k), -np.inf, dtype=np.float32)
        res_i = np.zeros((d, qn, k), dtype=np.int64)
        cert = np.zeros((d, qn), dtype=bool)
        active = np.flatnonzero(routed_mask).astype(np.int64)
        tiers_stats = []
        for tau_frac, pool_min, _ in StreamEngine.MS_TIERS:
            if active.size == 0:
                break
            a = active.size
            remap = np.full(qn, -1, dtype=np.int64)
            remap[active] = np.arange(a)
            c_pool = int(
                min(
                    _bucket(max(16 * k, pool_min), 1),
                    StreamEngine.MS_POOL_CAP,
                )
            )

            # Host prep per shard: impact-ordered prefix + spans.
            preps = []
            p_needed, t_needed, span_max = 1, 1, 1
            for si in range(d):
                lids, qs = shard_terms[si]
                sel = remap[qs] >= 0
                lids_a, qidx_a = lids[sel], remap[qs[sel]]
                order, bounds = tabs[si]
                tws = self._streams[si].token_w_start
                lo, hi, cut, s_rem, _ = _ms_prefix_prep(
                    order, bounds, tws, lids_a, qidx_a, a,
                    tau_frac, 0.0,
                )
                wsrc = doc_ordered(
                    order[np.repeat(lo, cut) + group_positions(cut)], cut
                )
                q_of = np.repeat(qidx_a, cut)
                sizes = np.bincount(q_of, minlength=a).astype(np.int64)
                nt = np.bincount(qidx_a, minlength=a).astype(np.int64)
                preps.append(
                    dict(
                        qidx=qidx_a, lo=lo, hi=hi, s_rem=s_rem,
                        wsrc=wsrc, q_of=q_of, sizes=sizes, n_terms=nt,
                        cut=cut,
                    )
                )
                p_needed = max(p_needed, int(sizes.max(initial=1)))
                t_needed = max(t_needed, int(nt.max(initial=1)))
                span_max = max(span_max, int(np.max(hi - lo, initial=1)))
            p_b = _bucket(p_needed, 8)
            tmax = int(_bucket(t_needed, 2))
            seg_steps = int(t_needed - 1).bit_length()

            # Phase 1: per-shard prefix pools, chunked by lane budget.
            wmat = np.full((d, a, p_b), self._swmax, dtype=np.int32)
            for si, pr in enumerate(preps):
                if pr["wsrc"].size:
                    pos = group_positions(pr["sizes"])
                    wmat[si, pr["q_of"], pos] = pr["wsrc"]
            sp = np.full((d, a, c_pool), -np.inf, dtype=np.float32)
            ip = np.full((d, a, c_pool), nmax, dtype=np.int64)
            a_cap = max(1, (1 << 26) // (p_b * 128))
            for a0 in range(0, a, a_cap):
                a1 = min(a, a0 + a_cap)
                for si in range(d):
                    pr = preps[si]
                    seg_off = segment_offsets(
                        pr["cut"], pr["qidx"], np.arange(a0, a1), a
                    )
                    s_d, i_d = stream_sparse_topk(
                        self.dev_st_words[si], s1_eff[si],
                        *self._stream_tables(si)[1:],
                        self._put(wmat[si, a0:a1]),
                        c_pool, nmax, seg_steps, torch.from_numpy(seg_off),
                    )
                    s = s_d.cpu().numpy()
                    i = i_d.cpu().numpy().astype(np.int64)
                    w = s.shape[1]
                    sp[si, a0:a1, :w] = s
                    ip[si, a0:a1, :w] = np.where(np.isfinite(s), i, nmax)

            theta = sp[:, :, k - 1].astype(np.float64)  # [d, a]
            last = sp[:, :, -1].astype(np.float64)
            s_rem = np.stack([pr["s_rem"] for pr in preps])  # [d, a]
            n_fin = np.isfinite(sp).sum(axis=2)
            # Fully-scored pairs: every matched window was in the
            # prefix and the pool didn't overflow — pool scores are the
            # exact complete scores for every matching doc.
            trivial = (s_rem == 0.0) & (n_fin < c_pool)
            hopeless = ~np.isfinite(theta) & ~trivial

            # Candidates: pool entries that could reach the kth.
            th_pad = theta - 4.0 * np.spacing(
                np.abs(theta).astype(np.float32)
            ).astype(np.float64)
            mask = (
                np.isfinite(sp)
                & (sp.astype(np.float64) + s_rem[:, :, None]
                   >= th_pad[:, :, None])
                & ~(trivial | hopeless)[:, :, None]
            )
            cand_ids = np.where(mask, ip, nmax)
            cand_ids.sort(axis=2)
            c_pad = int(
                _bucket(max(int(mask.sum(2).max(initial=1)), k), 16)
            )
            cand = cand_ids[:, :, :c_pad].astype(np.int32)
            if c_pad > cand_ids.shape[2]:
                cand = np.pad(
                    cand_ids,
                    ((0, 0), (0, 0), (0, c_pad - cand_ids.shape[2])),
                    constant_values=nmax,
                ).astype(np.int32)

            # Per-(shard, query, term) doc-ascending window spans for
            # the rescore's binary search.
            t_lo = np.zeros((d, a, tmax), dtype=np.int32)
            t_hi = np.zeros((d, a, tmax), dtype=np.int32)
            for si, pr in enumerate(preps):
                qidx_a = pr["qidx"]
                if qidx_a.size:
                    qstart = np.concatenate(
                        ([0], np.cumsum(pr["n_terms"]))
                    )
                    tpos = (
                        np.arange(qidx_a.size, dtype=np.int64)
                        - qstart[qidx_a]
                    )
                    t_lo[si, qidx_a, tpos] = pr["lo"]
                    t_hi[si, qidx_a, tpos] = pr["hi"]

            rs = np.full((d, a, k), -np.inf, dtype=np.float32)
            ri = np.zeros((d, a, k), dtype=np.int64)
            a_cap2 = max(1, (1 << 26) // (tmax * c_pad * 128))
            for a0 in range(0, a, a_cap2):
                a1 = min(a, a0 + a_cap2)
                for si in range(d):
                    s_d, i_d = rescore_topk(
                        self.dev_st_words[si], s1_eff[si],
                        *self._stream_tables(si)[1:],
                        self._put(cand[si, a0:a1]),
                        self._put(t_lo[si, a0:a1]),
                        self._put(t_hi[si, a0:a1]),
                        k, nmax,
                    )
                    rs[si, a0:a1] = s_d.cpu().numpy()[:, :k]
                    ri[si, a0:a1] = i_d.cpu().numpy().astype(np.int64)[:, :k]

            kth_exact = rs[:, :, k - 1].astype(np.float64)
            f_unseen, f_pool = _ms_certify(
                kth_exact.reshape(-1),
                last.reshape(-1),
                s_rem.reshape(-1),
            )
            pair_ok = trivial | (
                ~hopeless
                & ~(f_unseen | f_pool).reshape(d, a)
            )
            tiers_stats.append(
                {
                    "queries": int(a),
                    "tau_frac": tau_frac,
                    "windows_phase1": int(
                        sum(pr["sizes"].sum() for pr in preps)
                    ),
                    "pairs_trivial": int(trivial.sum()),
                    "pairs_certified": int(pair_ok.sum()),
                    "pairs": int(d * a),
                }
            )

            # Record certified pair results (trivial pairs: the pool's
            # top-k IS exact and already (score desc, id asc)-ranked).
            for si in range(d):
                tq = np.flatnonzero(trivial[si])
                if tq.size:
                    res_s[si, active[tq]] = sp[si, tq, :k]
                    res_i[si, active[tq]] = ip[si, tq, :k]
                rq = np.flatnonzero(pair_ok[si] & ~trivial[si])
                if rq.size:
                    res_s[si, active[rq]] = rs[si, rq]
                    res_i[si, active[rq]] = ri[si, rq]
                cert[si, active[pair_ok[si]]] = True

            q_ok = pair_ok.all(axis=0)
            active = active[~q_ok]
            if active.size == 0:
                break

        # Per-shard fallback accounting: windows the certified pairs
        # would have rescanned under whole-query fallback vs what the
        # partial rescan actually dispatches.
        fb_scanned = fb_skipped = 0
        if active.size:
            remap_a = np.full(qn, -1, dtype=np.int64)
            remap_a[active] = np.arange(active.size)
            for si in range(d):
                lids, qs = shard_terms[si]
                m = remap_a[qs] >= 0
                if not m.any():
                    continue
                tws = self._streams[si].token_w_start
                wcnt = (tws[lids[m] + 1] - tws[lids[m]]).astype(np.int64)
                certm = cert[si, qs[m]]
                fb_skipped += int(wcnt[certm].sum())
                fb_scanned += int(wcnt[~certm].sum())
        self.last_ms_stats = {
            "queries": qn,
            "batch_queries": qn,
            "routed_queries": int(routed_mask.sum()),
            "tiers": tiers_stats,
            "fallback_queries": int(active.size),
            "fallback_windows_scanned": fb_scanned,
            "fallback_windows_skipped": fb_skipped,
        }

        # Certification fallbacks + router-rejected queries take the
        # exhaustive sharded scan together.
        active = np.sort(np.concatenate([active, not_routed]))

        # Merge certified queries' per-shard top-ks host-side.
        done = np.setdiff1d(
            np.arange(qn, dtype=np.int64), active, assume_unique=False
        )
        if done.size:
            s_all = res_s[:, done].transpose(1, 0, 2).reshape(
                done.size, d * k
            )
            i_loc = res_i[:, done].transpose(1, 0, 2).reshape(
                done.size, d * k
            )
            g_ids = i_loc + np.repeat(doc_offsets, k)[None, :]
            fin = np.isfinite(s_all)
            g_ids = np.where(fin, g_ids, _INT_MAX)
            ordm = np.lexsort(
                (g_ids, -s_all.astype(np.float64)), axis=1
            )[:, :k]
            scores_out[done] = np.take_along_axis(s_all, ordm, axis=1)
            gids_out[done] = np.take_along_axis(g_ids, ordm, axis=1)

        # Per-shard fallback for queries some shard failed to certify:
        # only the UNCERTIFIED shards rescan (their windows ride the
        # exhaustive sharded dispatch; certified pairs' windows are
        # dropped from it), and the certified shards' exact local
        # top-ks merge host-side with the rescan's result.
        if active.size:
            a = active.size
            skip = cert[:, active]  # [d, a] True = exact local top-k known
            fs, fi = self._search_stream(
                [queries[int(j)] for j in active],
                k,
                fmask_dev,
                skip_pairs=skip,
            )
            s_cert = np.where(
                skip[:, :, None], res_s[:, active], -np.inf
            )  # [d, a, k]
            g_cert = res_i[:, active] + doc_offsets[:, None, None]
            g_cert = np.where(np.isfinite(s_cert), g_cert, _INT_MAX)
            s_all = np.concatenate(
                [
                    s_cert.transpose(1, 0, 2).reshape(a, d * k),
                    np.asarray(fs)[:, :k],
                ],
                axis=1,
            )
            g_all = np.concatenate(
                [
                    g_cert.transpose(1, 0, 2).reshape(a, d * k),
                    np.asarray(fi)[:, :k],
                ],
                axis=1,
            )
            ordm = np.lexsort(
                (g_all, -s_all.astype(np.float64)), axis=1
            )[:, :k]
            scores_out[active] = np.take_along_axis(s_all, ordm, axis=1)
            gids_out[active] = np.take_along_axis(g_all, ordm, axis=1)
        return scores_out, gids_out

    # ------------------------------------------------------------------
    def _upload_blockmax(self):
        """Stack per-shard range indexes (padded) for the pruned engine."""
        from ..index.ranges import build_range_index, default_range_size

        d = self.n_shards
        # One range size for EVERY shard: the stacked tables decode
        # doc = range*rs + local with a single rs, and the scale-aware
        # default would otherwise differ across shards straddling its
        # doc-count threshold (silently corrupting doc ids).
        rs = default_range_size(
            max((v.segment.n_docs for v in self.views), default=1)
        )
        # Impacts must bake in GLOBAL statistics (idf over all shards).
        self._range_indexes = []
        for v in self.views:
            gid = np.searchsorted(self.token_keys, v.segment.token_keys)
            self._range_indexes.append(
                build_range_index(
                    v.segment,
                    range_size=rs,
                    global_stats=(
                        self.n_docs,
                        self.sum_dl,
                        self.token_s0[gid],
                    ),
                )
            )
        ris = self._range_indexes
        self._rs = ris[0].range_size
        rmax = -(-self._nmax // self._rs)
        self._rmax = max(rmax, 1)
        vmax = max(max((v.segment.n_tokens for v in self.views), default=1), 1)
        self._vmax = vmax
        pmax = max(ri.post_impact.size for ri in ris)
        mmax = max(ri.tr_range.size for ri in ris)
        self._mmax = mmax

        if self.posting_mode == "tf":
            tf_max = max(
                (
                    int(v.segment.block_tfs.max())
                    for v in self.views
                    if v.segment.n_blocks
                ),
                default=0,
            )
            if tf_max > 0xFFFF:
                raise ValueError(
                    f"posting_mode='tf' stores term frequencies in at "
                    f"most 16 bits (max tf here: {tf_max}); use "
                    f"posting_mode='impact'"
                )
            tf_dt = np.uint8 if tf_max <= 0xFF else np.uint16
            post_tf = np.zeros((d, pmax), dtype=tf_dt)
            s0_tab = np.zeros((d, vmax + 2), dtype=np.float32)
            for i, (view, ri) in enumerate(zip(self.views, ris)):
                post_tf[i, : ri.post_tf.size] = ri.post_tf
                gid = np.searchsorted(
                    self.token_keys, view.segment.token_keys
                )
                s0_tab[i, : gid.size] = self.token_s0[gid]
            # u16 term frequencies travel as the same bits in int16.
            self.dev_bm_tf = self._put(
                post_tf if tf_dt == np.uint8 else post_tf.view(np.int16)
            )
            self._bm_s0 = s0_tab
            self.dev_bm_s0 = self._put(s0_tab)
            impact = None
        else:
            self.dev_bm_tf = None
            self._bm_s0 = None
            self.dev_bm_s0 = None
            impact = np.zeros((d, pmax), dtype=np.float32)
        local = np.zeros((d, pmax), dtype=np.uint8)
        tr_range = np.full((d, mmax + 1), np.iinfo(np.int32).max, np.int32)
        # Group lengths are tr_start diffs (see blockmax.py); every slot
        # at or past a shard's group count holds its posting total so pad
        # groups read length 0.
        tr_start = np.zeros((d, mmax + 2), dtype=np.int32)
        tr_ub = np.zeros((d, mmax + 1), dtype=np.float32)
        csr = np.zeros((d, vmax + 2), dtype=np.int32)
        term_l = np.zeros((d, vmax), dtype=np.int64)

        for i, (view, ri) in enumerate(zip(self.views, ris)):
            v = view.segment.n_tokens
            m = ri.tr_range.size
            total = int(ri.tr_start[-1] + ri.tr_len[-1]) if m else 0
            if impact is not None:
                impact[i, : ri.post_impact.size] = ri.post_impact
            local[i, : ri.post_local.size] = ri.post_local
            tr_range[i, :m] = ri.tr_range
            tr_start[i, :m] = ri.tr_start
            tr_start[i, m:] = total
            tr_ub[i, :m] = ri.tr_ub
            csr[i, : v + 1] = ri.token_tr_start
            csr[i, v + 1 :] = ri.token_tr_start[v]
            term_l[i, :v] = np.diff(ri.token_tr_start)
        self._term_l_shard = term_l

        put = self._put
        self.dev_bm_impact = put(impact) if impact is not None else None
        self.dev_bm_local = put(local)
        self.dev_bm_tr_range = put(tr_range)
        self.dev_bm_tr_start = put(tr_start)
        self.dev_bm_tr_ub = put(tr_ub)
        self.dev_bm_csr = put(csr)

    def memory_report(self) -> dict:
        """Device-resident bytes across all shards (the equal-index-memory
        metric; per-engine breakdown mirrors the single-chip engines), by
        the reference's formula."""

        def nbytes(t):
            return int(t.numel() * t.element_size())

        # doc_live f32 + the ones mask f32 + fieldnorms u8, per shard.
        doc_tables = (4 + 4 + 1) * self.n_shards * (self._nmax + 1)
        postings = 0
        meta = 0
        if self.engine in ("blockmax", "hybrid"):
            stream = (
                self.dev_bm_tf
                if self.posting_mode == "tf"
                else self.dev_bm_impact
            )
            postings += nbytes(stream) + nbytes(self.dev_bm_local)
            if self.posting_mode == "tf":
                doc_tables += nbytes(self.dev_bm_s0)
            meta += (
                nbytes(self.dev_bm_tr_range)
                + nbytes(self.dev_bm_tr_start)
                + nbytes(self.dev_bm_tr_ub)
                + nbytes(self.dev_bm_csr)
            )
        if self.dev_post_docid is not None:
            postings += nbytes(self.dev_post_docid) + nbytes(self.dev_post_impact)
        if self.engine == "stream":
            postings += nbytes(self.dev_st_words)
            meta += sum(
                nbytes(t)
                for t in (
                    self.dev_st_w_off,
                    self.dev_st_w_base,
                    self.dev_st_w_meta,
                    self.dev_st_w_s0,
                )
            )
            doc_tables += nbytes(self.dev_st_s1bd)
        n_post = max(
            1, sum(int(v.segment.block_n.sum()) for v in self.views)
        )
        total = postings + meta + doc_tables
        return {
            "postings": postings,
            "range_meta": meta,
            "doc_tables": doc_tables,
            "total": total,
            "bytes_per_posting": (postings + meta) / n_post,
        }

    # ------------------------------------------------------------------
    def _prepare_blockmax(self, queries: Sequence[Query]):
        """Per-shard local term ids for the pruned engine."""
        qn = len(queries)
        t_needed, l_needed = 1, 1
        per_shard = []
        for si, view in enumerate(self.views):
            ids_q = []
            for query in queries:
                seg = view.segment
                lids = seg.lookup_tokens(query.keys)
                lids = lids[lids >= 0].astype(np.int64)
                ids_q.append(lids)
                t_needed = max(t_needed, lids.size)
                if lids.size:
                    li = self._term_l_shard[si][lids]
                    l_needed = max(l_needed, int(li.max()))
            per_shard.append(ids_q)
        t_max = _bucket(t_needed, 4)
        q_tid = np.full(
            (self.n_shards, qn, t_max), self._vmax, dtype=np.int32
        )
        for si, ids_q in enumerate(per_shard):
            for qi, lids in enumerate(ids_q):
                q_tid[si, qi, : lids.size] = lids
        return q_tid, _bucket(l_needed, 8)

    def _search_blockmax(self, queries: Sequence[Query], k: int, fmask_dev):
        """Per shard, the Block-Max rounds (B1-bounds, then B1-select, P1 or
        P1-tf and B1-merge a round) on the shard's rows; then SH-merge."""
        q_tid, lmax = self._prepare_blockmax(queries)
        chunk = min(64, self._rmax)
        max_rounds = -(-self._rmax // chunk) + 1
        # Per-shard k must not be capped at all — not by the shard's doc
        # count (the global merge needs k candidates per shard when
        # available) and not by the per-round candidate pool (the running
        # top-k accumulates across rounds, so its width may exceed one
        # round's pool).
        kk = _bucket(k, 1)
        tf_mode = self.posting_mode == "tf"
        runs = self._runs(len(queries), kk, pads=True)
        for si in range(self.n_shards):
            tf_args = ()
            if tf_mode:
                tf_args = (
                    self.dev_bm_tf[si],
                    self.dev_doc_fn[si],
                    self.dev_s1,
                    self._put(self._bm_s0[si][q_tid[si]]),
                )
            _blockmax_kernel(
                None if tf_mode else self.dev_bm_impact[si],
                self.dev_bm_local[si],
                self.dev_doc_live[si],
                fmask_dev[si],
                self.dev_bm_tr_range[si],
                self.dev_bm_tr_start[si],
                self.dev_bm_tr_ub[si],
                self.dev_bm_csr[si],
                self._put(q_tid[si]),
                *tf_args,
                k=kk,
                chunk=chunk,
                lmax=lmax,
                range_size=self._rs,
                n_ranges=self._rmax,
                n_docs=self._nmax,
                max_rounds=max_rounds,
                posting_mode=self.posting_mode,
                topk=(runs[0][si], runs[1][si]),
            )
        return self._merged(runs, [kk] * self.n_shards, kk)

    # ------------------------------------------------------------------
    def _prepare_compact(self, queries: Sequence[Query]):
        """Per-shard padded (term, range) group-id lists for the compact
        exact strategy (CSR slices of each shard's range index), and each
        group's term ordinal inside its query (pad -1) for E3."""
        qn = len(queries)
        per_shard = []
        g_needed = 1
        for si, view in enumerate(self.views):
            ri = self._range_indexes[si]
            starts = ri.token_tr_start
            grps_q = []
            for query in queries:
                lids = view.segment.lookup_tokens(query.keys)
                lids = lids[lids >= 0].astype(np.int64)
                if lids.size:
                    los = starts[lids]
                    his = starts[lids + 1]
                    grps = np.concatenate(
                        [
                            np.arange(lo, hi, dtype=np.int64)
                            for lo, hi in zip(los, his)
                        ]
                    )
                    ords = np.repeat(
                        np.arange(lids.size, dtype=np.int64), his - los
                    )
                else:
                    grps = ords = np.zeros(0, dtype=np.int64)
                grps_q.append((grps, ords))
                g_needed = max(g_needed, grps.size)
            per_shard.append(grps_q)
        g_max = _bucket(g_needed, 8)
        # Pad slot mmax: tr_start[mmax+1] - tr_start[mmax] = 0 per shard.
        grp_ids = np.full(
            (self.n_shards, qn, g_max), self._mmax, dtype=np.int32
        )
        grp_ord = np.full((self.n_shards, qn, g_max), -1, dtype=np.int32)
        for si, grps_q in enumerate(per_shard):
            for qi, (grps, ords) in enumerate(grps_q):
                if grps.size:
                    grp_ids[si, qi, : grps.size] = grps
                    grp_ord[si, qi, : grps.size] = ords
        return grp_ids, grp_ord

    def _search_compact(self, queries: Sequence[Query], k: int, fmask_dev):
        """Exact scoring over the compact flat postings: per shard, E3 into
        a dense accumulator, the live and filter masks, S2; then SH-merge
        (the sharded analog of exact.py's _score_and_topk_compact)."""
        grp_ids, grp_ord = self._prepare_compact(queries)
        kk = _bucket(k, 1)
        width = min(kk, self._nmax)
        runs = self._runs(len(queries), width)
        for si in range(self.n_shards):
            acc = exact_compact_accumulate(
                self.dev_bm_impact[si],
                self.dev_bm_local[si],
                self.dev_bm_tr_range[si],
                self.dev_bm_tr_start[si],
                self._put(grp_ids[si]),
                self._put(grp_ord[si]),
                int(grp_ord[si].max(initial=-1)) + 1,
                self._nmax,
                self._rs,
            )
            acc.mul_(self.dev_doc_live[si]).mul_(fmask_dev[si])
            self._dense_local(acc, runs, si)
            del acc
        return self._merged(runs, [width] * self.n_shards, kk)

    # ------------------------------------------------------------------
    def _prepare(self, queries: Sequence[Query]):
        """Per-shard padded posting-row windows for a replicated query
        batch (dense exact engine).  One global token lookup over the
        concatenated batch keys, then a vectorized repeat/cumsum CSR
        expansion per shard (see search/exact.py's _win_lists), with each
        window's term ordinal inside its query (pad -1) for E1."""
        q = len(queries)
        g_all, q_all = batch_lookup(self.lookup_tokens, queries)

        per_shard = []
        p_needed = 1
        for si, view in enumerate(self.views):
            csr = self._flat_csr[si]
            lids = view.local_tid[g_all] if g_all.size else g_all
            ok = lids >= 0
            lt, qt = lids[ok], q_all[ok]
            if lt.size:
                s = csr[lt].astype(np.int64)
                e = csr[lt + 1].astype(np.int64)
                nz = e > s
                s, e, qt = s[nz], e[nz], qt[nz]
            if lt.size and s.size:
                r0 = s // BLOCK
                cnt = (e - 1) // BLOCK - r0 + 1
                rows = np.repeat(r0, cnt) + group_positions(cnt)
                lo = np.maximum(np.repeat(s, cnt) - rows * BLOCK, 0)
                hi = np.minimum(np.repeat(e, cnt) - rows * BLOCK, BLOCK)
                q_of = np.repeat(qt, cnt)
                ords = np.repeat(
                    group_positions(np.bincount(qt, minlength=q)), cnt
                )
                sizes = np.bincount(q_of, minlength=q).astype(np.int64)
                p_needed = max(p_needed, int(sizes.max(initial=1)))
            else:
                rows = lo = hi = ords = np.zeros(0, dtype=np.int64)
                q_of = np.zeros(0, dtype=np.int64)
                sizes = np.zeros(q, dtype=np.int64)
            per_shard.append((rows, lo, hi, ords, q_of, sizes))

        p_max = _bucket(p_needed, 8)
        shape = (self.n_shards, q, p_max)
        win_row = np.full(shape, self._rpmax, dtype=np.int32)
        win_lo = np.zeros(shape, dtype=np.int32)
        win_hi = np.zeros(shape, dtype=np.int32)
        win_ord = np.full(shape, -1, dtype=np.int32)
        for si, (rows, lo, hi, ords, q_of, sizes) in enumerate(per_shard):
            if rows.size:
                pos = np.arange(rows.size, dtype=np.int64) - np.repeat(
                    np.cumsum(sizes) - sizes, sizes
                )
                win_row[si, q_of, pos] = rows
                win_lo[si, q_of, pos] = lo
                win_hi[si, q_of, pos] = hi
                win_ord[si, q_of, pos] = ords
        return win_row, win_lo, win_hi, win_ord

    def _search_dense(self, queries, k, fmask_dev):
        """Per shard, E1 over its posting rows with the filter, S2; then
        SH-merge.  The reference multiplies the 0/1 filter into every
        lane before the adds; E1 multiplies the sum as it writes it, which
        gives the same bits (x * 1 = x, and a zeroed doc sums to +0 either
        way); with no filter it multiplies nothing."""
        unfiltered = fmask_dev is self._dev_ones
        win_row, win_lo, win_hi, win_ord = self._prepare(queries)
        kk = _bucket(k, 1)
        width = min(kk, self._nmax)
        runs = self._runs(len(queries), width)
        for si in range(self.n_shards):
            acc = exact_dense_accumulate(
                self.dev_post_docid[si],
                self.dev_post_impact[si],
                self.dev_doc_live[si],
                self._put(win_row[si]),
                self._put(win_lo[si]),
                self._put(win_hi[si]),
                self._put(win_ord[si]),
                int(win_ord[si].max(initial=-1)) + 1,
                self._nmax,
                filter_mask=None if unfiltered else fmask_dev[si],
            )
            self._dense_local(acc, runs, si)
            del acc
        return self._merged(runs, [width] * self.n_shards, kk)

    # ------------------------------------------------------------------
    def _route(self, queries: Sequence[Query]) -> np.ndarray:
        """Hybrid strategy per query: 1 = compact full scan (selective),
        2 = iterative pruned (df-heavy) — mirrors HybridEngine's router."""
        df_budget = max(1.0, 0.10 * max(self.n_docs, 1))
        qn = len(queries)
        dfs = np.zeros(qn, dtype=np.int64)
        ids, qidx = batch_lookup(self.lookup_tokens, queries)
        if ids.size:
            np.add.at(dfs, qidx, self.token_df[ids])
        return np.where(dfs > df_budget, np.int8(2), np.int8(1))

    def _device_search(self, queries, k, fmask_dev):
        """Top-k over the sealed shards only (device path)."""
        if self.engine == "blockmax":
            return self._search_blockmax(queries, k, fmask_dev)
        if self.engine == "stream":
            # The single-chip engine's gate, on the largest shard.
            if routes_maxscore(self.strategy, self._nmax, k):
                return self._search_stream_ms(queries, k, fmask_dev)
            return self._search_stream(queries, k, fmask_dev)
        if self.engine == "exact":
            return self._search_dense(queries, k, fmask_dev)
        # Hybrid: route per query, dispatch each group, reassemble.
        # Dense strategy: posting-aligned flat rows in "fast" mode (the
        # single-chip hybrid default); the range-aligned compact stream
        # only in "compact" mode (one copy on the device).
        dense_fn = (
            self._search_dense
            if self.memory_mode == "fast"
            else self._search_compact
        )
        # Heavy group: exhaustive dense scoring, mirroring the
        # single-chip HybridEngine's heavy_mode="exact" default.
        strategy = self._route(queries)
        qn = len(queries)
        scores = np.full((qn, k), -np.inf, dtype=np.float32)
        gids = np.full((qn, k), np.iinfo(np.int32).max, dtype=np.int64)
        for strat, fn in (
            (1, dense_fn),
            (2, dense_fn),
        ):
            idx = np.flatnonzero(strategy == strat)
            # Cap each dispatch so the per-shard [q, nmax] accumulator
            # stays under 1 GiB.
            q_cap = max(1, (1 << 30) // (4 * (self._nmax + 1)))
            for i0 in range(0, idx.size, q_cap):
                sub = idx[i0 : i0 + q_cap]
                s, i = fn([queries[j] for j in sub], k, fmask_dev)
                scores[sub] = np.asarray(s)[:, :k]
                gids[sub] = np.asarray(i)[:, :k]
        return scores, gids

    def search(
        self,
        queries: Sequence[Query],
        k: Optional[int] = None,
        filter_fn: Optional[Callable[[int], bool]] = None,
        session: Optional[SessionConfig] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched top-k over all shards + the growing segment; returns
        (scores, global doc ids, payloads) with the pinned
        (score desc, doc asc) tie rule.

        filter_fn: payload predicate.  With prefilter enabled it is
        evaluated inside device retrieval (honest top-k threshold);
        otherwise it post-filters the k results.  k=-1 or
        session.enable_scan=False take the brute-force path.
        """
        sess = session or SessionConfig()
        if k is None:
            k = sess.resolve_limit(self.search_options)
        if not sess.enable_scan or k == -1:
            if k == 0:
                raise ValueError("number of needed rows is set to 0")
            return self._search_all(queries, k, filter_fn)
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        if filter_fn is not None and not sess.resolve_prefilter(
            self.search_options
        ):
            # Post-filter mode: retrieve unfiltered, filter the results.
            scores, gids, payloads = self.search(queries, k=k, session=session)
            from ..index.bm25index import _eval_predicate

            keep = (gids >= 0) & _eval_predicate(
                filter_fn, payloads.reshape(-1)
            ).reshape(payloads.shape)
            return (
                np.where(keep, scores, -np.inf),
                np.where(keep, gids, -1),
                np.where(keep, payloads, -1),
            )
        with self._rw.read():
            return self._search_locked(queries, k, filter_fn)

    def _search_locked(self, queries, k, filter_fn):
        with self._mutex:
            if self._deleted_dirty:
                self._refresh_deleted()

        if filter_fn is not None:
            from ..index.bm25index import _eval_predicate

            fkeep = _eval_predicate(filter_fn, self.global_payloads)
            fmask_dev = self._put(
                self._shard_doc_array(fkeep.astype(np.float32), fill=0.0)
            )
        else:
            fmask_dev = self._dev_ones

        scores, gids = self._device_search(queries, k, fmask_dev)
        scores = np.asarray(scores)[:, :k]
        gids = np.asarray(gids, dtype=np.int64)[:, :k]
        valid = np.isfinite(scores) & (scores > 0) & (gids < self.n_docs)
        gids = np.where(valid, gids, -1)
        payloads = np.where(
            valid, self.global_payloads[np.maximum(gids, 0)], -1
        )
        scores = np.where(valid, scores, -np.inf)

        # Merge growing-segment hits (global stats; growing global ids
        # follow the sealed doc space): the growing prefix's and tail's
        # blocks ranked with the sealed results in the facade's merge.
        g = len(self.growing)
        if g:
            from ..index.bm25index import _eval_predicate, merge_ranked

            g_payloads = np.asarray(self.growing.payloads, dtype=np.int64)
            keep = (
                _eval_predicate(filter_fn, g_payloads)
                if filter_fn is not None
                else None
            )
            g_base = self.n_docs
            # Growing top-k served from the device (no O(Q x G) host
            # work — see GrowingSegment.device_engine).
            ids, qidx = batch_lookup(self.lookup_tokens, queries)
            g_blocks = self.growing.topk_batch_async(ids, qidx, len(queries), k, keep)()
            dtype = scores.dtype
            scores, gids, payloads = merge_ranked(
                [(scores.astype(np.float64), gids, payloads)]
                + [
                    (s, np.where(i >= 0, g_base + i, -1), g_payloads[np.maximum(i, 0)])
                    for s, i in g_blocks
                ],
                k,
            )
            scores = scores.astype(dtype)
        return scores, gids, payloads

    # ------------------------------------------------------------------
    def _oracle_scores_global(self, query: Query) -> np.ndarray:
        """Dense global-doc scores on host (global stats) — the sharded
        brute-force path (0.2.x bm25_limit = -1 / enable_scan = off)."""
        acc = np.zeros(self.n_docs, dtype=np.float64)
        g_tids = self.lookup_tokens(query.keys)
        g_tids = g_tids[g_tids >= 0]
        for view in self.views:
            seg = view.segment
            if not seg.n_docs:
                continue
            lids = view.local_tid[g_tids] if g_tids.size else np.zeros(0, np.int64)
            for gt, lt in zip(g_tids, lids):
                if lt < 0:
                    continue
                lo = int(seg.token_block_start[lt])
                hi = int(seg.token_block_start[lt + 1])
                docs = seg.block_docids[lo:hi].reshape(-1)
                tfs = seg.block_tfs[lo:hi].reshape(-1)
                mask = docs < seg.n_docs
                docs, tfs = docs[mask], tfs[mask]
                fn = seg.doc_fieldnorm[docs].astype(np.int64)
                t = tfs.astype(np.float64)
                s1 = self.tables.s1_table[fn]
                acc[view.doc_offset + docs] += (
                    t * self.token_s0[gt]
                ) / (t + s1)
        acc[self.deleted] = 0.0
        return acc

    def _search_all(self, queries, k, filter_fn):
        """Brute force: every matching doc (score > 0), best first."""
        from ..index.bm25index import _eval_predicate

        qn = len(queries)
        fkeep = (
            _eval_predicate(filter_fn, self.global_payloads)
            if filter_fn is not None
            else None
        )
        out_s, out_g, out_p = [], [], []
        for query in queries:
            scores = self._oracle_scores_global(query)
            if fkeep is not None:
                scores = np.where(fkeep, scores, 0.0)
            hits = [
                (float(scores[g]), int(g), int(self.global_payloads[g]))
                for g in np.flatnonzero(scores > 0)
            ]
            g_scores, g_payloads = self.growing.score(
                query, filter_fn=filter_fn
            )
            hits += [
                (float(s), self.n_docs + i, int(p))
                for i, (s, p) in enumerate(zip(g_scores, g_payloads))
                if s > 0.0
            ]
            hits.sort(key=lambda t: (-t[0], t[1]))
            if k != -1:
                hits = hits[:k]
            out_s.append([h[0] for h in hits])
            out_g.append([h[1] for h in hits])
            out_p.append([h[2] for h in hits])
        width = max((len(x) for x in out_s), default=0)
        scores = np.full((qn, width), -np.inf, dtype=np.float32)
        gids = np.full((qn, width), -1, dtype=np.int64)
        payloads = np.full((qn, width), -1, dtype=np.int64)
        for qi in range(qn):
            m = len(out_s[qi])
            scores[qi, :m] = out_s[qi]
            gids[qi, :m] = out_g[qi]
            payloads[qi, :m] = out_p[qi]
        return scores, gids, payloads

    # ------------------------------------------------------------------
    def global_stats_step(self):
        """The build's global-statistics step on the device: SH-stats sums
        each shard's live lengths in f64 (exact: integers below 2^53) and
        scans the shard doc counts, and the host adds the D partial sums
        (the reference's psum over the mesh).  Returns (N, sum dl, avgdl)."""
        partial, offsets = shard_stats(
            self.dev_doc_fn, self.dev_doc_live, self.dev_n_local
        )
        n = int(offsets[-1].item())
        sdl = int(sum(float(x) for x in partial.cpu().numpy()))
        return n, sdl, (sdl / n if n else 1.0)
