"""Bm25Index on torch (counterpart of ``index/bm25index.py``).

Subclasses the reference facade: build, insert, bulkdelete, maintain,
prefilter, single-query search and the host growing path are the
reference's own code.  Only the engine construction is replaced, so the
sealed segment is served by the port's ``BlockMaxEngine`` on ``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vectorchord_bm25_tpu.index.bm25index import Bm25Index as _ReferenceIndex
from vectorchord_bm25_tpu.index.sealed import SealedSegment
from vectorchord_bm25_tpu.text.intern import Document
from vectorchord_bm25_tpu.utils.options import IndexOptions, SearchOptions

__all__ = ["Bm25Index"]

# ROADMAP.md items that bring the reference's other engines to the port.
_NOT_PORTED = {
    "stream": "queue 1: StreamEngine slices",
    "exact": "queue 1: ExactEngine",
    "hybrid": "queue 1: HybridEngine",
}


class Bm25Index(_ReferenceIndex):
    """The reference facade with its sealed segment served on ``device``.

    Only ``engine="blockmax"`` is ported; the other engines raise
    ``NotImplementedError`` when first used."""

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
        super().__init__(
            sealed, seed, options, search_options,
            engine=engine, engine_options=engine_options,
        )
        self.device = torch.device(device)

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
        """CREATE INDEX analog (the reference's build), served on device."""
        index = super().build(
            documents, payloads, options, search_options, seed,
            engine=engine, engine_options=engine_options,
            reorder=reorder, progress=progress,
        )
        index.device = torch.device(device)
        return index

    @classmethod
    def from_reference(
        cls, ref: _ReferenceIndex, device="cuda", engine_options=None
    ) -> "Bm25Index":
        """Port index over a reference index's host state (sealed segment,
        delete bitmap, growing segment, seed and options) — e.g. a
        checkpoint read by ``index/storage.py:load_index``."""
        index = cls(
            ref.sealed, ref.seed, ref.options, ref.search_options,
            engine="blockmax", engine_options=engine_options, device=device,
        )
        index.deleted = ref.deleted.copy()
        for doc, payload in zip(ref.growing.documents, ref.growing.payloads):
            index.growing.insert(doc, payload)
        index.growing.apply_delete_mask(list(ref.growing.deleted))
        return index

    def _engine_locked(self):
        if self._engine is None:
            if self.engine_kind != "blockmax":
                raise NotImplementedError(
                    f"engine={self.engine_kind!r} is not ported yet "
                    f"(ROADMAP.md {_NOT_PORTED[self.engine_kind]}); use "
                    f"engine='blockmax'"
                )
            from ..search.blockmax import BlockMaxEngine

            self._engine = BlockMaxEngine(
                self.sealed, device=self.device, **self.engine_options
            )
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        elif self._engine_deleted_dirty:
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        return self._engine

    def _search_batch_dispatch(self, queries, k, filter_fn=None):
        if len(self.growing):
            # The reference serves growing docs in a batch through its jax
            # StreamEngine (index/growing.py).
            raise NotImplementedError(
                "search_batch over a non-empty growing segment is not "
                "ported yet (ROADMAP.md queue 1: growing search_batch); "
                "call maintain() first, or use search()"
            )
        return super()._search_batch_dispatch(queries, k, filter_fn)
