"""Growing segment on torch (counterpart of ``index/growing.py``).

The reference's ``GrowingSegment`` with one method replaced: the device
engine over the frozen prefix of the growing postings is the port's
``StreamEngine`` on ``device``.  Inserts, deletes, the host-scored tail,
``topk_batch_async`` and ``_tail_topk`` are the reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorchord_bm25_tpu.index.growing import GrowingSegment as _Reference
from vectorchord_bm25_tpu.index.sealed import (
    SealedSegment,
    build_sealed_segment_from_postings,
)

__all__ = ["GrowingSegment"]


class GrowingSegment(_Reference):
    """Append-only buffer of inserted docs, batch-served on ``device``."""

    def __init__(self, sealed: SealedSegment, device="cuda"):
        super().__init__(sealed)
        self.device = torch.device(device)

    def _mini_segment(self):
        """The growing docs as a mini sealed segment keyed by sealed token
        id, with the sealed statistics to score it by: the reference's
        ``device_engine`` build (index/growing.py:268-326), which has no
        entry point of its own.  Returns (segment, global_stats)."""
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
        return seg, (int(self.sealed.n_docs), int(self.sealed.sum_dl), s0v)

    def device_engine(self):
        """The port's StreamEngine over a frozen prefix of the growing
        postings (reference ``device_engine``, index/growing.py:246-341):
        built on the first batch and whenever ``topk_batch_async`` drops it
        to absorb the tail; deletes only refresh its bitmap."""
        if self._dev_engine is None:
            from ..search.stream import StreamEngine

            seg, stats = self._mini_segment()
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
