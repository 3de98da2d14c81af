"""PyTorch / CUDA port of tpu-bm25.

A second package beside ``vectorchord_bm25_tpu`` (the reference).  It
imports ``torch`` and never ``jax``: the reference's host code (segment
build, range index, tokenizer, options, oracle, numpy query planning) is
jax-free and is imported unchanged; only the modules that touch the
device are ported.  Public API:

    from vectorchord_bm25_tpu_torch import Bm25Index, Query, Document
    index = Bm25Index.build(docs, engine="blockmax", device="cuda")
    hits = index.search_batch(queries, k=10)
"""

__version__ = "0.1.0"

__all__ = [
    "Bm25Index",
    "Document",
    "Query",
    "IndexOptions",
    "SearchOptions",
    "SessionConfig",
    "build_sealed_segment_from_postings",
    "oracle_scores",
    "oracle_topk",
]

# Names re-exported from the reference's jax-free host modules.
_REFERENCE = {
    "Document": "vectorchord_bm25_tpu.text.intern",
    "Query": "vectorchord_bm25_tpu.text.intern",
    "IndexOptions": "vectorchord_bm25_tpu.utils.options",
    "SearchOptions": "vectorchord_bm25_tpu.utils.options",
    "SessionConfig": "vectorchord_bm25_tpu.utils.options",
    "build_sealed_segment_from_postings": "vectorchord_bm25_tpu.index.sealed",
    "oracle_scores": "vectorchord_bm25_tpu.search.exact",
    "oracle_topk": "vectorchord_bm25_tpu.search.exact",
}


def __getattr__(name):
    # Lazy, so importing the package loads neither torch nor the reference.
    import importlib

    if name == "Bm25Index":
        from .index.bm25index import Bm25Index

        return Bm25Index
    if name in _REFERENCE:
        return getattr(importlib.import_module(_REFERENCE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
