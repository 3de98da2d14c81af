"""Corpus ingestion: text -> interned Documents, batched.

The corpus-scan hot loop of the reference's build path
(HeapTraverser + cast_tsvector_to_document, SURVEY.md §3.1 HOT LOOP 1)
— here a host pipeline: tokenize (tsvector-style), batch-intern through
the native library when built (vcbm25_intern_batch), sort/dedup into
Document vectors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..native import loader
from .intern import WIDTH, Document, intern
from .tokenizer import tsvector

__all__ = ["documents_from_texts", "document_from_counts"]


def document_from_counts(seed: bytes, counts: Dict[str, int]) -> Document:
    """One document from lexeme counts, using the native interner when
    available."""
    if not counts:
        return Document(
            keys=np.zeros(0, dtype=f"S{WIDTH}"),
            values=np.zeros(0, dtype=np.uint32),
        )
    tokens = [
        t.encode("utf-8") if isinstance(t, str) else bytes(t) for t in counts
    ]
    values = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
    keys = loader.intern_batch(seed, tokens)
    if keys is None:
        keys = np.asarray(
            [intern(seed, t) for t in tokens], dtype=f"S{WIDTH}"
        )
    else:
        keys = keys.reshape(-1)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    values = values[order]
    # Interning can collide distinct lexemes onto one key only via hash
    # collision (negligible) — but duplicate keys can arise from
    # equal-after-encoding tokens; merge defensively.
    if keys.size > 1 and np.any(keys[1:] == keys[:-1]):
        uniq, inverse = np.unique(keys, return_inverse=True)
        merged = np.zeros(uniq.size, dtype=np.int64)
        np.add.at(merged, inverse, values)
        keys, values = uniq, merged
    values = np.minimum(values, 0xFFFFFFFF).astype(np.uint32)
    mask = values != 0
    return Document(keys=keys[mask], values=values[mask])


def documents_from_texts(
    seed: bytes,
    texts: Sequence[str],
    tokenizer: Optional[Callable[[str], Dict[str, int]]] = None,
    progress=None,
) -> List[Document]:
    """Tokenize + intern a text corpus (default tokenizer: tsvector-style
    English)."""
    tok = tokenizer or tsvector
    out: List[Document] = []
    for i, text in enumerate(texts):
        out.append(document_from_counts(seed, tok(text)))
        if progress is not None and (i + 1) % 10000 == 0:
            progress("ingest", i + 1, len(texts))
    return out
