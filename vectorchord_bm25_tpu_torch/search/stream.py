"""Exact batched search over the compressed posting stream
(counterpart of ``search/stream.py``), dense strategy.

The served default: ``Bm25Index`` builds this engine unless told
otherwise, and ``strategy="auto"`` takes the dense reduction below
``SPARSE_MIN_DOCS`` (2^21) docs.  Per dispatch of a batch:

1. the host plans the windows of every query term (the reference's own
   ``_win_lists``) and cuts the batch into the reference's dispatches
   (``q_cap`` queries bounded by the 1 GiB accumulator budget, at most
   ``t_cap`` = 2^19 windows);
2. ``ops/stream_kernel.py`` decodes, scores and adds every window into a
   ``[n_q, N+1]`` accumulator, one term ordinal at a time so the adds land
   in the reference's order;
3. ``ops/topk.py`` takes the exact hierarchical top-k of each row.

``StreamEngine`` subclasses the reference engine: the numpy planning
(``_win_lists``, ``_assemble``, ``_s1_by_doc_host``), ``set_deleted``,
``memory_report`` and ``search`` are the reference's own, running on the
torch tensors uploaded here.  Only the methods that reach jax are
replaced.  The reference's ``_throttle_large`` (a jax-only guard against
a TPU dispatch pile-up) has no counterpart: each dispatch's accumulator
is freed before the next one is allocated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vectorchord_bm25_tpu.index.sealed import SealedSegment
from vectorchord_bm25_tpu.index.stream import StreamIndex, build_stream_index
from vectorchord_bm25_tpu.search.stream import StreamEngine as _ReferenceEngine
from vectorchord_bm25_tpu.text.intern import Query
from vectorchord_bm25_tpu.utils.buckets import bucket_pow2 as _bucket

from ..ops.stream_kernel import stream_dense_accumulate
from ..ops.topk import dense_topk
from ..utils.device import as_device

__all__ = ["StreamEngine", "window_ordinals"]

_NOT_PORTED = (
    "is not ported yet (ROADMAP.md queue 1 item 2: StreamEngine slices 2-3, "
    "the sparse and MaxScore reductions); use strategy='dense' below 2^21 docs"
)


def window_ordinals(stream: StreamIndex, wsrc, starts, sizes) -> np.ndarray:
    """Each window's term ordinal inside its query, from ``_win_lists``'
    output: a query's windows are term-major, and a new term entry starts
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


class StreamEngine(_ReferenceEngine):
    """Batched exact search from the compressed stream, on torch.

    The dense strategy only (``"dense"``, or ``"auto"`` below
    ``SPARSE_MIN_DOCS``); on a CUDA device every dispatch runs the
    ``stream_dense_accumulate`` and ``dense_topk`` kernels, on the CPU
    their plain PyTorch versions."""

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

        # The reference's set_deleted re-uploads through _put.
        self._put = put
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

    def _s1_eff(self, filter_mask: Optional[np.ndarray]):
        """dev_s1bd with filtered docs (filter value <= 0) forced to +inf."""
        if filter_mask is None:
            return self.dev_s1bd
        fm = np.ones(self.n_docs + 1, dtype=np.float32)
        fm[: self.n_docs] = np.asarray(filter_mask, dtype=np.float32)
        keep = torch.from_numpy(fm).to(self.device) > 0.0
        return torch.where(keep, self.dev_s1bd, float("inf"))

    def _check_dense(self) -> None:
        if self.strategy in ("sparse", "maxscore"):
            raise NotImplementedError(f"strategy={self.strategy!r} {_NOT_PORTED}")
        if self.strategy == "auto" and self.n_docs >= self.SPARSE_MIN_DOCS:
            raise NotImplementedError(
                f"strategy='auto' at {self.n_docs} docs (>= "
                f"SPARSE_MIN_DOCS = {self.SPARSE_MIN_DOCS}) {_NOT_PORTED}"
            )

    def _dispatches(self, queries: Sequence[Query]):
        """The reference's dense chunking (search/stream.py:1016-1047):
        yields (query rows, wsrc [tb] int32, wq [tb] int32, word_ord [tb],
        n_qb) per dispatch, windows in the reference's order with pad
        windows (len 0) up to the bucketed tb."""
        qn = len(queries)
        n_docs = self.n_docs
        lists, _ = self._win_lists(queries)
        wsrc_all, starts, sizes = lists
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
            wq = np.zeros(tb, dtype=np.int32)
            wq[:t] = np.repeat(
                np.arange(q1 - q0, dtype=np.int32), sizes[q0:q1]
            )
            word_ord = np.zeros(tb, dtype=np.int64)
            word_ord[:t] = ord_all[t0:t1]
            yield np.arange(q0, q1), wsrc, wq, word_ord, _bucket(q1 - q0, 8)
            q0 = q1

    def search_async(
        self,
        queries: Sequence[Query],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Dispatch a batch and return finalize() -> (scores, ids,
        payloads): the reference's dense branch (search/stream.py:939-1065)
        and finalize (:1105-1127)."""
        if k <= 0:
            raise ValueError("number of needed rows is set to 0")
        self.last_ms_stats = None
        self._check_dense()
        queries = list(queries)
        qn = len(queries)
        n_docs = self.n_docs
        s1_eff = self._s1_eff(filter_mask)
        kk = min(_bucket(k, 1), max(n_docs, 1))
        tables = (self.dev_w_off, self.dev_w_base, self.dev_w_meta, self.dev_w_s0)

        pending = []
        for rows, wsrc, wq, word_ord, n_qb in self._dispatches(queries):
            # Group the windows by ordinal on the host, so the kernel's
            # launches read contiguous spans.
            order = np.argsort(word_ord, kind="stable")
            acc = stream_dense_accumulate(
                self.dev_words, s1_eff, *tables,
                torch.from_numpy(wsrc[order]).to(self.device),
                torch.from_numpy(wq[order]).to(self.device),
                word_ord[order], n_qb, n_docs,
            )
            pending.append((rows, dense_topk(acc, kk, n_docs)))
            # Only the [n_qb, kk] results stay queued: the accumulator
            # (1 GiB at the budget) is released before the next dispatch.
            del acc

        payload_arr = np.asarray(self.segment.doc_payload)

        def finalize():
            scores = np.full((qn, k), -np.inf, dtype=np.float32)
            ids = np.full((qn, k), -1, dtype=np.int64)
            payloads = np.full((qn, k), -1, dtype=np.int64)
            for sub, (s_dev, i_dev) in pending:
                # Dense rows are pow2-bucketed; drop the padding rows.
                s = s_dev.cpu().numpy()[: sub.size, :k]
                i = i_dev.cpu().numpy().astype(np.int64)[: sub.size, :k]
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
