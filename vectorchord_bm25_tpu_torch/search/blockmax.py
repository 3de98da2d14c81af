"""Block-Max pruned batched search (counterpart of ``search/blockmax.py``).

The same algorithm as the reference, on torch tensors:

1. scatter-add each query term's per-range max scores into a dense
   [Q, n_ranges] upper-bound matrix;
2. per round, take the C highest-bound unprocessed ranges, exact-score
   all their postings with a fused kernel, merge into the running top-k
   with a (score desc, doc asc) order and raise the threshold;
3. stop when no remaining range's bound exceeds the threshold.

The reference runs all of it as one device program, step 2 inside
``lax.while_loop``.  Here every step is a kernel (``ops/blockmax_round.py``:
B1-bounds for step 1; per round B1-select, the scoring kernel, B1-merge),
and the loop is a Python ``while`` that reads one device flag a round, the
one sync a round.  The scoring kernel depends on the posting form
(``ops/score_kernel.py``):

- ``posting_mode="impact"``: P1 ``fused_range_scores`` over precomputed
  f32 impacts, or bf16 ones (``impact_dtype="bfloat16"``: half the
  postings' bytes; the range bounds are scaled by 1 + 2^-7 to cover the
  rounding, as the reference does);
- ``posting_mode="tf"``: P1-tf ``tf_range_scores`` over u8/u16 term
  frequencies, each score rebuilt from the doc's fieldnorm (2 B a
  posting, the reference extension's index memory).

``search_rangescan_async`` is the exhaustive sweep (the reference's
``_rangescan_kernel``): every range in chunks through P1, written straight
into a ``[Q, n_chunks*C*RS]`` accumulator, then the exact top-k of
``ops/topk.py`` (S2).  The numpy host planning (``_prepare``) is a copy of
the reference's, on a batch already looked up in the segment's token table
(``utils/batchkeys.py::batch_lookup``): the ``*_ids_async`` entries serve
that form, and ``search_async`` and ``search_rangescan_async`` look
``Query`` objects up and call them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.ranges import RangeIndex, build_range_index, ranges_from_reference
from ..index.sealed import SealedSegment, segment_from_reference
from ..ops.blockmax_round import (
    locate as _locate,
    range_bounds,
    round_merge,
    round_select,
    term_windows as _term_windows,
)
from ..ops.score_kernel import fused_range_scores, tf_range_scores
from ..ops.topk import dense_topk
from ..text.intern import Query
from ..utils.batchkeys import batch_lookup, group_positions
from ..utils.buckets import bucket_pow2 as _bucket
from ..utils import tracing
from ..utils.device import as_device
from .device import DeviceSegment
from .stream import _host, _upload

__all__ = ["BlockMaxEngine"]

# The span of a finalize's blocking copies of the results to the host.
_WAIT = "vcbm25.blockmax.wait"

_INT_MAX = int(np.iinfo(np.int32).max)


def _blockmax_kernel(
    post_impact,  # [P] f32 or bf16 precomputed per-posting scores (pad = 0)
    post_local,  # [P] uint8 range-relative doc ids
    doc_live,  # [N+1] float32
    filter_mask,  # [N+1] float32
    tr_range,  # [M+1] int32 (pad slot: INT_MAX)
    tr_start,  # [M+2] int32 (slots M and M+1 hold the total)
    tr_ub,  # [M+1] float32
    token_tr_start,  # [V+2] int32 CSR
    q_tid,  # [Q, T] int32 (pad = V, the null term)
    post_tf=None,  # [P] u8 / int16 (u16 bits) term frequencies (tf mode)
    doc_fn=None,  # [N+1] u8 fieldnorms (tf mode)
    s1_table=None,  # [256] float32 (tf mode)
    q_s0=None,  # [Q, T] float32 per-term s0 (tf mode)
    *,
    k: int,
    chunk: int,
    lmax: int,
    range_size: int,
    n_ranges: int,
    n_docs: int,
    max_rounds: int,
    posting_mode: str = "impact",
    topk=None,
):
    """Block-Max search; returns (topk_s [Q,k] f32, topk_d [Q,k] i32,
    rounds).  topk: an optional contiguous (scores, ids) [Q, k] pair,
    holding (-inf, INT_MAX) on entry, to keep the running top-k in (the
    sharded body hands each shard its slice of one stacked pair); it is
    returned."""
    q = q_tid.shape[0]
    rs, c = range_size, chunk
    dev = q_tid.device

    # Phase 1 (B1-bounds): dense per-range upper bounds, each range's terms
    # summed in ascending t, times the reference's float-safety scale.
    with tracing.span("vcbm25.blockmax.bounds"):
        ub_work = range_bounds(
            token_tr_start, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax
        )
    if topk is None:
        topk_s = torch.full((q, k), float("-inf"), dtype=torch.float32, device=dev)
        topk_d = torch.full((q, k), _INT_MAX, dtype=torch.int32, device=dev)
    else:
        topk_s, topk_d = topk
    # One zeroed flag a round: B1-select raises it if any query is active.
    flags = torch.zeros(max(max_rounds, 1), dtype=torch.int32, device=dev)

    rounds = 0
    with tracing.span("vcbm25.blockmax.rounds"):
        while rounds < max_rounds:
            # B1-select: the C highest-bound ranges above the threshold and
            # their posting spans; ub_work and the flag are updated in place.
            cand_r, start, length, active = round_select(
                ub_work, topk_s, tr_range, tr_start, token_tr_start, q_tid,
                chunk=c, lmax=lmax, flag=flags[rounds : rounds + 1],
            )
            with tracing.span("vcbm25.blockmax.flag"):
                go = bool(active)  # the round's one device-to-host read
            if not go:
                break

            if posting_mode == "tf":
                acc = tf_range_scores(
                    post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, start,
                    length, rs=rs, n_docs=n_docs,
                )  # [Q, C, RS]
            else:
                acc = fused_range_scores(
                    post_impact, post_local, start, length, rs=rs
                )  # [Q, C, RS]

            # B1-merge: live/filter mask, score > 0 rule, lexicographic merge
            # into topk_s / topk_d in place.
            round_merge(acc, cand_r, doc_live, filter_mask, topk_s, topk_d, n_docs=n_docs)
            rounds += 1
    tracing.count("blockmax_rounds", rounds)
    return topk_s, topk_d, rounds


def _rangescan_kernel(
    post_impact,  # [P] f32 or bf16 precomputed per-posting scores (pad = 0)
    post_local,  # [P] uint8 range-relative doc ids
    doc_live,  # [N+1] float32
    filter_mask,  # [N+1] float32
    tr_range,  # [M+1] int32 (pad slot: INT_MAX)
    tr_start,  # [M+2] int32
    token_tr_start,  # [V+2] int32 CSR
    q_tid,  # [Q, T] int32 (pad = V)
    *,
    k: int,
    chunk: int,
    lmax: int,
    range_size: int,
    n_ranges: int,
    n_docs: int,
):
    """Exhaustive range-aligned scoring (the reference's
    ``_rangescan_kernel``, search/blockmax.py:236-338): every range in
    chunks of C, each chunk's [Q, C, RS] scores from P1, written straight
    into its columns of a [Q, n_chunks*C*RS] accumulator (the reference's
    ``dynamic_update_slice`` is a pure copy, so the bits are the same).
    The host loop reads nothing back.  Deletes and the filter are applied
    in place on the first ``n_docs`` columns; the columns past them hold
    0 (no posting lands there), which is what the top-k needs.  Returns
    S2's (scores [Q, k], ids [Q, k])."""
    q, t = q_tid.shape
    rs, c = range_size, chunk
    dev = q_tid.device
    n_chunks = -(-n_ranges // c)
    qt_range, qt_start, qt_len, _ = _term_windows(
        tr_range, tr_start, None, token_tr_start, q_tid, lmax
    )
    width = n_chunks * c * rs
    # Rows start 16-B aligned (S2's vector loads): the row stride is
    # rounded up to 4 floats.  Every column below ``width`` is written.
    acc = torch.empty((q, (width + 3) & ~3), dtype=torch.float32, device=dev)
    acc = acc[:, :width]
    c_iota = torch.arange(c, dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        cand_r = (ci * c + c_iota).expand(q, c)
        start, length = _locate(qt_range, qt_start, qt_len, cand_r, lmax)
        fused_range_scores(
            post_impact, post_local, start, length, rs=rs,
            out=acc[:, ci * c * rs : (ci + 1) * c * rs],
        )
    cols = acc[:, :n_docs]
    cols.mul_(doc_live[:n_docs]).mul_(filter_mask[:n_docs])
    return dense_topk(acc, k, n_docs)


def _finish(segment, scores: np.ndarray, ids: np.ndarray, k: int):
    """The reference's result contract: [Q, k] scores desc, doc slots and
    payloads, padded with -inf / -1."""
    scores = scores[:, :k]
    ids = ids.astype(np.int64)[:, :k]
    if scores.shape[1] < k:
        # Fewer doc slots than k: pad back to the [Q, k] contract.
        pad = k - scores.shape[1]
        scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
    valid = np.isfinite(scores) & (ids < segment.n_docs) & (ids >= 0)
    ids = np.where(valid, ids, -1)
    payloads = np.where(valid, segment.doc_payload[np.maximum(ids, 0)], -1)
    return np.where(valid, scores, -np.inf), ids, payloads


class BlockMaxEngine:
    """Batched Block-Max pruned search over one sealed segment, on torch.

    On a CUDA device the bounds and every pruning round run CUDA kernels
    (B1-bounds; B1-select, P1 or P1-tf in ``posting_mode="tf"``, B1-merge),
    on the CPU their plain PyTorch versions."""

    def __init__(
        self,
        segment: SealedSegment,
        range_index: Optional[RangeIndex] = None,
        chunk: Optional[int] = None,
        device="cuda",
        impact_dtype: str = "float32",
        posting_mode: str = "impact",
        use_pallas=None,
    ):
        """use_pallas: accepted so a reference index's engine options (e.g.
        from a checkpoint's ``meta.json``) serve unchanged, and ignored: the
        tensors' device picks the kernel.

        posting_mode:
        - "impact": precomputed per-posting f32/bf16 scores (5/3 B per
          posting; no query-time math).
        - "tf": equal-index-memory form, 2 B/posting lossless — u8 tf
          (u16 if any tf > 255) + u8 range-local doc id; each score is
          rebuilt per posting by P1-tf, as the reference extension's
          decompress-and-score loop does (search.rs:498-518,
          bm25.rs:334-359).
        """
        if posting_mode not in ("impact", "tf"):
            raise ValueError(f"unknown posting_mode {posting_mode!r}")
        self.device = as_device(device)
        self.posting_mode = posting_mode
        self.impact_dtype = impact_dtype
        self.segment = segment
        if range_index is None:
            with tracing.span("vcbm25.build.ranges"):
                range_index = build_range_index(segment)
        self.ranges = range_index
        if chunk is None:
            # The reference's scale-aware default: the worst-case round
            # count stays bounded without over-gathering on small corpora.
            chunk = min(256, max(32, self.ranges.n_ranges // 64))
        self.chunk = chunk
        with tracing.span("vcbm25.build.upload"):
            # The pruned engine needs only the doc tables, not the [B, 128]
            # block arrays (its postings live in the compact flat arrays).
            self.dev = DeviceSegment.from_sealed(
                segment, device=self.device, with_blocks=False
            )

            ri = self.ranges
            v = segment.n_tokens
            if ri.post_impact.size >= 2**31 or ri.token_tr_start[-1] >= 2**31:
                raise ValueError(
                    "index exceeds int32 posting/group addressing (2^31); "
                    "shard the corpus across devices"
                )

            def put(x, dtype=None):
                return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
                    self.device
                )

            # The reference's uploads (search/blockmax.py:414-468).  CSR with
            # the null-term entry (token id V: empty window) + pad slot M.
            tts = np.zeros(v + 2, dtype=np.int32)
            tts[: v + 1] = ri.token_tr_start
            tts[v + 1] = tts[v]
            if posting_mode == "tf":
                tf_max = int(segment.block_tfs.max()) if segment.n_blocks else 0
                if tf_max > 0xFFFF:
                    raise ValueError(
                        f"posting_mode='tf' stores term frequencies in at "
                        f"most 16 bits (max tf here: {tf_max}); use "
                        f"posting_mode='impact'"
                    )
                # u16 term frequencies travel as the same bits in int16.
                tf_host = (
                    ri.post_tf.astype(np.uint8)
                    if tf_max <= 0xFF
                    else ri.post_tf.astype(np.uint16).view(np.int16)
                )
                self.dev_post_impact = None
                self.dev_post_tf = put(tf_host)
                fn_pad = np.zeros(segment.n_docs + 1, dtype=np.uint8)
                fn_pad[: segment.n_docs] = segment.doc_fieldnorm
                self.dev_doc_fn = put(fn_pad)
                self.dev_s1 = put(segment.score_tables().s1_table, np.float32)
                s0_host = np.zeros(segment.n_tokens + 1, dtype=np.float32)
                s0_host[: segment.n_tokens] = segment.token_s0()
                self._s0_host = s0_host  # the null term V scores 0
            else:
                impact = put(ri.post_impact, np.float32)
                if impact_dtype == "bfloat16":
                    # Round to nearest even, as the reference's jnp cast does.
                    impact = impact.to(torch.bfloat16)
                self.dev_post_impact = impact
                self.dev_post_tf = None
                self.dev_doc_fn = None
                self.dev_s1 = None
                self._s0_host = None
            self.dev_post_local = put(ri.post_local, np.uint8)
            self.dev_tr_range = put(np.append(ri.tr_range, _INT_MAX), np.int32)
            # Group lengths are tr_start diffs; slots M and M+1 hold the total
            # so the pad group reads length 0.
            total = int(ri.tr_start[-1] + ri.tr_len[-1]) if ri.tr_len.size else 0
            self.dev_tr_start = put(np.append(ri.tr_start, [total, total]), np.int32)
            ub = np.append(ri.tr_ub, 0.0).astype(np.float32)
            if impact_dtype == "bfloat16":
                # bf16 round-to-nearest can raise a posting's stored impact by
                # up to 2^-8 relative; pruning bounds must cover that.
                ub = ub * np.float32(1.0 + 2.0**-7)
            self.dev_tr_ub = put(ub)
            self.dev_token_tr_start = put(tts)
            # Per-term L (for the lmax bucket).
            self._term_l = np.diff(ri.token_tr_start)
        self.last_rounds = 0

    @classmethod
    def from_reference(
        cls,
        ref,
        range_index: Optional[RangeIndex] = None,
        device="cuda",
        deleted: Optional[np.ndarray] = None,
    ) -> "BlockMaxEngine":
        """Port engine over a copy of a reference engine's state, or over a
        sealed segment of either package (with an optional RangeIndex of
        either package and a delete bitmap).  Segments and range indexes
        cross by value."""
        if range_index is not None:
            range_index = ranges_from_reference(range_index)
        if not hasattr(ref, "segment"):  # a sealed segment
            engine = cls(segment_from_reference(ref), range_index, device=device)
        else:
            engine = cls(
                segment_from_reference(ref.segment),
                range_index or ranges_from_reference(ref.ranges),
                chunk=ref.chunk,
                device=device,
                impact_dtype=ref.impact_dtype,
                posting_mode=ref.posting_mode,
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
        """Device-resident index bytes (the equal-index-memory metric), by
        the reference's formula (search/blockmax.py:475-507): the posting
        streams, the per-(term, range) metadata (+ pad slots), the int32
        CSR, the doc-live mask and, in tf mode, the u8 fieldnorms."""
        ri = self.ranges
        doc_tables = 4 * (self.segment.n_docs + 1)  # doc_live f32
        m1 = ri.tr_range.size + 1  # + pad slot
        # tr_range/start/ub (+ the extra total slot of tr_start); group
        # lengths are derived on device from start diffs.
        range_meta = (4 + 4 + 4) * m1 + 4
        csr = 4 * (self.segment.n_tokens + 2)
        if self.posting_mode == "tf":
            postings = self.dev_post_tf.nbytes + ri.post_local.nbytes
            doc_tables += self.segment.n_docs + 1  # fieldnorms u8
        else:
            postings = self.dev_post_impact.nbytes + ri.post_local.nbytes
        total = postings + range_meta + csr + doc_tables
        return {
            "postings": postings,
            "range_meta": range_meta,
            "token_csr": csr,
            "doc_tables": doc_tables,
            "total": total,
            "bytes_per_posting": (postings + range_meta)
            / max(1, ri.post_local.size - ri.range_size),
        }

    def _prepare(self, ids: np.ndarray, qidx: np.ndarray, qn: int):
        """Host prep of a looked-up batch of ``qn`` queries: only the
        padded ``[Q, T]`` term-id matrix and the lmax bucket; everything
        else is on device."""
        seg = self.segment
        if ids.size == 0:
            # Match the non-empty path's minimum buckets so the jit
            # cache is shared with normal batches.
            return np.full((qn, 4), seg.n_tokens, dtype=np.int32), 8
        sizes = np.bincount(qidx, minlength=qn).astype(np.int64)
        t_max = _bucket(int(sizes.max(initial=1)) or 1, 4)
        q_tid = np.full((qn, t_max), seg.n_tokens, dtype=np.int32)
        q_tid[qidx, group_positions(sizes)] = ids
        l_needed = int(self._term_l[ids].max())
        return q_tid, _bucket(max(1, l_needed), 8)

    def _filter(self, filter_mask):
        fm = np.ones(self.dev.n_docs + 1, dtype=np.float32)
        if filter_mask is not None:
            fm[: self.dev.n_docs] = np.asarray(filter_mask, dtype=np.float32)
        return _upload(fm, self.device)

    def search_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        chunk: Optional[int] = None,
    ):
        """``search_ids_async`` on the batch looked up in this engine's
        token table."""
        queries = list(queries)
        ids, qidx = batch_lookup(self.segment.lookup_tokens, queries)
        return self.search_ids_async(ids, qidx, len(queries), k, filter_mask, chunk)

    @tracing.traced("vcbm25.blockmax.dispatch")
    def search_ids_async(
        self,
        ids: np.ndarray,
        qidx: np.ndarray,
        qn: int,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        chunk: Optional[int] = None,
    ):
        """Run the pruning rounds over a batch of ``qn`` queries looked up
        in this engine's token table (``ids``, ``qidx`` as ``batch_lookup``
        gives them) and return finalize() -> (scores, ids, payloads); the
        last round's device work may still be queued."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        chunk = self.chunk if chunk is None else chunk
        dev = self.dev
        ri = self.ranges
        with tracing.span("vcbm25.blockmax.lookup"):
            q_tid, lmax = self._prepare(ids, qidx, qn)
        with tracing.span("vcbm25.blockmax.upload"):
            tf_args = ()
            if self.posting_mode == "tf":
                q_s0 = self._s0_host[np.minimum(q_tid, self.segment.n_tokens)]
                tf_args = (
                    self.dev_post_tf,
                    self.dev_doc_fn,
                    self.dev_s1,
                    _upload(q_s0, self.device),
                )
            filt = self._filter(filter_mask)
            d_tid = _upload(q_tid, self.device)

        kk = min(_bucket(k, 1), max(dev.n_docs, 1))
        top_s, top_i, rounds = _blockmax_kernel(
            self.dev_post_impact,
            self.dev_post_local,
            dev.doc_live,
            filt,
            self.dev_tr_range,
            self.dev_tr_start,
            self.dev_tr_ub,
            self.dev_token_tr_start,
            d_tid,
            *tf_args,
            k=kk,
            chunk=min(chunk, ri.n_ranges),
            lmax=lmax,
            range_size=ri.range_size,
            n_ranges=ri.n_ranges,
            n_docs=dev.n_docs,
            max_rounds=-(-ri.n_ranges // chunk) + 1,
            posting_mode=self.posting_mode,
        )
        self.last_rounds = rounds

        @tracing.traced("vcbm25.blockmax.finalize")
        def finalize():
            return _finish(self.segment, _host(top_s, _WAIT), _host(top_i, _WAIT), k)

        return finalize

    def search_rangescan_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """``search_rangescan_ids_async`` on the batch looked up in this
        engine's token table."""
        queries = list(queries)
        ids, qidx = batch_lookup(self.segment.lookup_tokens, queries)
        return self.search_rangescan_ids_async(ids, qidx, len(queries), k, filter_mask)

    @tracing.traced("vcbm25.blockmax.dispatch")
    def search_rangescan_ids_async(
        self,
        ids: np.ndarray,
        qidx: np.ndarray,
        qn: int,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Exhaustive range-sweep scoring (no pruning, no scatter) of a
        looked-up batch: see ``_rangescan_kernel``.  Exact results, the
        contract of ``search_async``."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        if self.posting_mode != "impact":
            raise ValueError(
                "rangescan reads precomputed impacts; use "
                "posting_mode='impact'"
            )
        dev = self.dev
        ri = self.ranges
        q_tid, lmax = self._prepare(ids, qidx, qn)
        kk = min(_bucket(k, 1), max(dev.n_docs, 1))
        # The reference's chunk rule (search/blockmax.py:637-644), copied
        # for parity: one chunk's XLA working set (~12 B a lane) stays
        # near 128 MB, rounded down to a power of two.
        t = q_tid.shape[1]
        budget = max(64, (128 << 20) // max(1, qn * t * ri.range_size * 12))
        chunk = 1 << (int(budget).bit_length() - 1)
        chunk = int(min(chunk, ri.n_ranges))
        top_s, top_i = _rangescan_kernel(
            self.dev_post_impact,
            self.dev_post_local,
            dev.doc_live,
            self._filter(filter_mask),
            self.dev_tr_range,
            self.dev_tr_start,
            self.dev_token_tr_start,
            _upload(q_tid, self.device),
            k=kk,
            chunk=chunk,
            lmax=lmax,
            range_size=ri.range_size,
            n_ranges=ri.n_ranges,
            n_docs=dev.n_docs,
        )

        @tracing.traced("vcbm25.blockmax.finalize")
        def finalize():
            return _finish(self.segment, _host(top_s, _WAIT), _host(top_i, _WAIT), k)

        return finalize

    def search(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        chunk: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact top-k via block-max pruning.

        Same result contract as ExactEngine.search (scores desc, doc slots,
        payloads; -inf/-1 padding).  `chunk` overrides the per-round
        candidate count — setting it at or above every query's total range
        count turns the search into a single-round scan with no threshold
        iteration (the light-query fast path).
        """
        return self.search_async(queries, k, filter_mask, chunk)()
