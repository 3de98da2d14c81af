"""Bm25Index on torch (counterpart of ``index/bm25index.py``).

Subclasses the reference facade: build, insert, bulkdelete, maintain,
prefilter, search and the batch merge of sealed and growing hits are the
reference's own code.  Only the engine construction and the growing
segment are replaced, so the sealed segment is served by the port's
``StreamEngine`` (the default) or ``BlockMaxEngine``, and a non-empty
growing segment by the port's ``GrowingSegment``, all on ``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vectorchord_bm25_tpu.index.bm25index import Bm25Index as _ReferenceIndex
from vectorchord_bm25_tpu.index.sealed import SealedSegment
from vectorchord_bm25_tpu.text.intern import Document
from vectorchord_bm25_tpu.utils.options import IndexOptions, SearchOptions

from .growing import GrowingSegment

__all__ = ["Bm25Index"]

# ROADMAP.md items that bring the reference's other engines to the port.
_NOT_PORTED = {
    "exact": "queue 1: ExactEngine",
    "hybrid": "queue 1: HybridEngine",
}


class Bm25Index(_ReferenceIndex):
    """The reference facade with its segments served on ``device``.

    ``engine="stream"`` (the default, dense strategy) and
    ``engine="blockmax"`` are ported; the other engines raise
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
        self.growing = GrowingSegment(sealed, device=self.device)

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
        index.growing = GrowingSegment(index.sealed, device=index.device)
        return index

    @classmethod
    def from_reference(
        cls, ref: _ReferenceIndex, device="cuda", engine_options=None
    ) -> "Bm25Index":
        """Port index over a reference index's host state (sealed segment,
        delete bitmap, growing segment, seed, options, engine and engine
        options) — e.g. a checkpoint read by ``index/storage.py:load_index``.
        ``engine_options``, when given, replaces the reference's.  An engine
        the port lacks raises when first used, as in the constructor."""
        if engine_options is None:
            engine_options = ref.engine_options
        index = cls(
            ref.sealed, ref.seed, ref.options, ref.search_options,
            engine=ref.engine_kind, engine_options=engine_options,
            device=device,
        )
        index.deleted = ref.deleted.copy()
        for doc, payload in zip(ref.growing.documents, ref.growing.payloads):
            index.growing.insert(doc, payload)
        index.growing.apply_delete_mask(list(ref.growing.deleted))
        return index

    def _engine_locked(self):
        if self._engine is None:
            kw = self.engine_options
            if self.engine_kind == "stream":
                from ..search.stream import StreamEngine

                self._engine = StreamEngine(self.sealed, device=self.device, **kw)
            elif self.engine_kind == "blockmax":
                from ..search.blockmax import BlockMaxEngine

                self._engine = BlockMaxEngine(self.sealed, device=self.device, **kw)
            else:
                raise NotImplementedError(
                    f"engine={self.engine_kind!r} is not ported yet "
                    f"(ROADMAP.md {_NOT_PORTED[self.engine_kind]}); use "
                    f"engine='stream' or 'blockmax'"
                )
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        elif self._engine_deleted_dirty:
            self._engine.set_deleted(self.deleted)
            self._engine_deleted_dirty = False
        return self._engine

    def _maintain_locked(self, progress=None) -> None:
        super()._maintain_locked(progress)
        # The reference re-creates its own (empty) growing segment.
        self.growing = GrowingSegment(self.sealed, device=self.device)
