"""Block-Max pruned batched search (counterpart of ``search/blockmax.py``).

The same algorithm as the reference, on torch tensors:

1. scatter-add each query term's per-range max scores into a dense
   [Q, n_ranges] upper-bound matrix;
2. per round, take the C highest-bound unprocessed ranges, exact-score
   all their postings with the fused kernel (``ops/score_kernel.py``),
   merge into the running top-k with a (score desc, doc asc) order and
   raise the threshold;
3. stop when no remaining range's bound exceeds the threshold.

The reference runs step 2 inside ``lax.while_loop`` on the device.  Here
it is a Python ``while`` whose condition is one device-to-host bool per
round — the one sync a round.

``BlockMaxEngine`` subclasses the reference engine, so the numpy host
planning (``_prepare``) and ``search`` are the reference's own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vectorchord_bm25_tpu.index.ranges import RangeIndex, build_range_index
from vectorchord_bm25_tpu.index.sealed import SealedSegment
from vectorchord_bm25_tpu.search.blockmax import (
    BlockMaxEngine as _ReferenceEngine,
)
from vectorchord_bm25_tpu.text.intern import Query
from vectorchord_bm25_tpu.utils.buckets import bucket_pow2 as _bucket

from ..ops.score_kernel import fused_range_scores
from ..ops.topk import lex_topk
from ..utils.device import as_device
from .device import DeviceSegment

__all__ = ["BlockMaxEngine"]

_INT_MAX = int(np.iinfo(np.int32).max)


def _blockmax_kernel(
    post_impact,  # [P] float32 precomputed per-posting scores (pad = 0)
    post_local,  # [P] uint8 range-relative doc ids
    doc_live,  # [N+1] float32
    filter_mask,  # [N+1] float32
    tr_range,  # [M+1] int32 (pad slot: INT_MAX)
    tr_start,  # [M+2] int32 (slots M and M+1 hold the total)
    tr_ub,  # [M+1] float32
    token_tr_start,  # [V+2] int32 CSR
    q_tid,  # [Q, T] int32 (pad = V, the null term)
    *,
    k: int,
    chunk: int,
    lmax: int,
    range_size: int,
    n_ranges: int,
    n_docs: int,
    max_rounds: int,
):
    """Impact-mode Block-Max search; returns (topk_s [Q,k] f32,
    topk_d [Q,k] i32, rounds)."""
    q, t = q_tid.shape
    rs, c = range_size, chunk
    m_pad = tr_range.shape[0] - 1  # index of the pad slot
    dev = q_tid.device
    neg_inf = float("-inf")

    # Gather each query term's (range, span, ub) window from the CSR.
    tid = q_tid.long()
    base = token_tr_start[tid]  # [Q, T]
    count = token_tr_start[tid + 1] - base
    l_iota = torch.arange(lmax, dtype=torch.int32, device=dev)
    widx = (base[..., None] + l_iota).clamp_max(m_pad).long()  # [Q, T, L]
    lmask = l_iota < count[..., None]
    qt_range = torch.where(lmask, tr_range[widx], _INT_MAX)  # ascending
    qt_start = torch.where(lmask, tr_start[widx], 0)
    qt_len = torch.where(lmask, tr_start[widx + 1] - tr_start[widx], 0)
    qt_ub = torch.where(lmask, tr_ub[widx], 0.0)

    # Phase 1: dense per-range upper bounds (sum over terms).  A term has
    # at most one group per range, so adding one term at a time needs no
    # atomics and sums each range's terms in ascending t.
    safe_r = torch.where(qt_range == _INT_MAX, n_ranges, qt_range).long()
    ub_work = torch.zeros((q, n_ranges + 1), dtype=torch.float32, device=dev)
    for ti in range(t):
        ub_work.scatter_add_(1, safe_r[:, ti], qt_ub[:, ti])
    # The reference's float-safety scale for a T-term f32 accumulation.
    scale = torch.tensor(1.0 + (t + 2) * 1.2e-7, dtype=torch.float32)
    ub_work = ub_work[:, :n_ranges] * scale

    topk_s = torch.full((q, k), neg_inf, dtype=torch.float32, device=dev)
    topk_d = torch.full((q, k), _INT_MAX, dtype=torch.int32, device=dev)
    rs_iota = torch.arange(rs, dtype=torch.int32, device=dev)

    rounds = 0
    while rounds < max_rounds:
        # score > 0 rule: the threshold starts at 0.
        thresh = topk_s[:, k - 1].clamp_min(0.0)
        if not bool((ub_work.amax(dim=1) > thresh).any()):
            break
        cand_ub, cand_r = torch.topk(ub_work, c, dim=1)  # [Q, C]
        ub_work = ub_work.scatter(1, cand_r, neg_inf)
        # Refilled already-processed (-inf) ranges and ranges at or below
        # the threshold must not be rescored.
        cand_ok = cand_ub > thresh[:, None]
        cand_r = cand_r.int()

        # Locate each (query term, candidate range) posting span.
        cand_qt = cand_r[:, None, :].expand(q, t, c).contiguous()
        idx = torch.searchsorted(qt_range, cand_qt).clamp_max(lmax - 1)
        found = (qt_range.gather(2, idx) == cand_qt) & cand_ok[:, None, :]
        start = torch.where(found, qt_start.gather(2, idx), 0)
        length = torch.where(found, qt_len.gather(2, idx), 0)

        acc = fused_range_scores(
            post_impact, post_local, start, length, rs=rs
        )  # [Q, C, RS]

        # Deleted/filtered docs are masked on the accumulated per-doc
        # scores (the factors are per-doc, so they distribute over terms).
        cand_docs = cand_r[:, :, None] * rs + rs_iota  # [Q, C, RS]
        cand_docs_c = cand_docs.clamp_max(n_docs).long()
        acc = acc * doc_live[cand_docs_c] * filter_mask[cand_docs_c]
        flat_s = acc.reshape(q, c * rs)
        flat_d = cand_docs.reshape(q, c * rs)
        ok = (flat_s > 0.0) & (flat_d < n_docs)
        flat_s = torch.where(ok, flat_s, neg_inf)
        flat_d = torch.where(ok, flat_d, _INT_MAX)

        topk_s, topk_d = lex_topk(
            torch.cat([topk_s, flat_s], dim=1),
            torch.cat([topk_d, flat_d], dim=1),
            k,
        )
        rounds += 1
    return topk_s, topk_d, rounds


def _finish(segment: SealedSegment, scores: np.ndarray, ids: np.ndarray, k: int):
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


class BlockMaxEngine(_ReferenceEngine):
    """Batched Block-Max pruned search over one sealed segment, on torch.

    Impact postings only; on a CUDA device every pruning round runs the
    fused CUDA kernel, on the CPU its plain PyTorch version."""

    def __init__(
        self,
        segment: SealedSegment,
        range_index: Optional[RangeIndex] = None,
        chunk: Optional[int] = None,
        device="cuda",
        impact_dtype: str = "float32",
        posting_mode: str = "impact",
    ):
        if posting_mode == "tf":
            raise NotImplementedError(
                "posting_mode='tf' is not ported yet (ROADMAP.md queue 2: "
                "posting_mode='tf')"
            )
        if posting_mode != "impact":
            raise ValueError(f"unknown posting_mode {posting_mode!r}")
        if impact_dtype != "float32":
            raise NotImplementedError(
                "bf16 impacts are not ported yet (ROADMAP.md queue 2: "
                "impact_dtype='bfloat16')"
            )
        self.device = as_device(device)
        self.posting_mode = posting_mode
        self.impact_dtype = impact_dtype
        self.segment = segment
        self.ranges = range_index or build_range_index(segment)
        if chunk is None:
            # The reference's scale-aware default (search/blockmax.py).
            chunk = min(256, max(32, self.ranges.n_ranges // 64))
        self.chunk = chunk
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

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
                self.device
            )

        # CSR with null-term entry (token id V: empty window) + pad slot M.
        tts = np.zeros(v + 2, dtype=np.int32)
        tts[: v + 1] = ri.token_tr_start
        tts[v + 1] = tts[v]
        total = int(ri.tr_start[-1] + ri.tr_len[-1]) if ri.tr_len.size else 0
        self.dev_post_impact = put(ri.post_impact, np.float32)
        self.dev_post_local = put(ri.post_local, np.uint8)
        self.dev_tr_range = put(np.append(ri.tr_range, _INT_MAX), np.int32)
        # Group lengths are tr_start diffs; slots M and M+1 hold the total
        # so the pad group reads length 0.
        self.dev_tr_start = put(np.append(ri.tr_start, [total, total]), np.int32)
        self.dev_tr_ub = put(np.append(ri.tr_ub, 0.0), np.float32)
        self.dev_token_tr_start = put(tts, np.int32)
        # Per-term L (for the lmax bucket in the reference's _prepare).
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
        """Port engine over a reference engine's state, or over a sealed
        segment (with an optional RangeIndex and delete bitmap)."""
        if isinstance(ref, SealedSegment):
            engine = cls(ref, range_index, device=device)
        else:
            engine = cls(
                ref.segment,
                range_index or ref.ranges,
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
        """Device-resident index bytes, from the uploaded tensors; the same
        dict the reference reports for the same index."""

        def nbytes(*tensors):
            return sum(x.numel() * x.element_size() for x in tensors)

        postings = nbytes(self.dev_post_impact, self.dev_post_local)
        range_meta = nbytes(self.dev_tr_range, self.dev_tr_start, self.dev_tr_ub)
        csr = nbytes(self.dev_token_tr_start)
        doc_tables = nbytes(self.dev.doc_live)
        return {
            "postings": postings,
            "range_meta": range_meta,
            "token_csr": csr,
            "doc_tables": doc_tables,
            "total": postings + range_meta + csr + doc_tables,
            "bytes_per_posting": (postings + range_meta)
            / max(1, self.dev_post_local.numel() - self.ranges.range_size),
        }

    def search_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        chunk: Optional[int] = None,
    ):
        """Run the pruning rounds and return finalize() -> (scores, ids,
        payloads); the last round's device work may still be queued."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        chunk = self.chunk if chunk is None else chunk
        dev = self.dev
        ri = self.ranges
        q_tid, lmax = self._prepare(queries)

        fm = np.ones(dev.n_docs + 1, dtype=np.float32)
        if filter_mask is not None:
            fm[: dev.n_docs] = np.asarray(filter_mask, dtype=np.float32)

        kk = min(_bucket(k, 1), max(dev.n_docs, 1))
        scores, ids, rounds = _blockmax_kernel(
            self.dev_post_impact,
            self.dev_post_local,
            dev.doc_live,
            torch.from_numpy(fm).to(self.device),
            self.dev_tr_range,
            self.dev_tr_start,
            self.dev_tr_ub,
            self.dev_token_tr_start,
            torch.from_numpy(q_tid).to(self.device),
            k=kk,
            chunk=min(chunk, ri.n_ranges),
            lmax=lmax,
            range_size=ri.range_size,
            n_ranges=ri.n_ranges,
            n_docs=dev.n_docs,
            max_rounds=-(-ri.n_ranges // chunk) + 1,
        )
        self.last_rounds = rounds

        def finalize():
            return _finish(
                self.segment, scores.cpu().numpy(), ids.cpu().numpy(), k
            )

        return finalize

    def search_rangescan_async(self, queries, k, filter_mask=None):
        raise NotImplementedError(
            "the exhaustive range sweep is not ported yet (ROADMAP.md "
            "queue 2: _rangescan_kernel / search_rangescan_async)"
        )
