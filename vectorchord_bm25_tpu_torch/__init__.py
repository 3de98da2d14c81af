"""PyTorch / CUDA port of tpu-bm25.

A second package beside ``vectorchord_bm25_tpu`` (the reference).  It
imports ``torch``, never ``jax``, and nothing of the reference: the host
code it needs (segment build, range index, compressed stream, tokenizer
interning, options, oracles, numpy query planning) is its own copy, and
the modules that touch the device are ported.  State built by the
reference crosses by value (``Bm25Index.from_reference``,
``segment_from_reference``) or by file: the checkpoint format of
``index/storage.py`` is the reference's, so either package opens what the
other saved.  Public API:

    from vectorchord_bm25_tpu_torch import Bm25Index, Query, Document
    index = Bm25Index.build(docs, engine="blockmax", device="cuda")
    hits = index.search_batch(queries, k=10)
    save_index(index, directory)
    index = open_index(directory, device="cuda")  # replays and attaches the WAL
    sharded = ShardedIndex.build(docs, 8, device="cuda")  # 8 shards, one card
    docs = documents_from_texts(seed, texts)  # tsvector-style English
"""

__version__ = "0.1.0"

__all__ = [
    "Bm25Index",
    "BoundQuery",
    "SearchHit",
    "Document",
    "Query",
    "random_seed",
    "IndexOptions",
    "SearchOptions",
    "SessionConfig",
    "build_sealed_segment",
    "build_sealed_segment_from_postings",
    "segment_from_reference",
    "BlockMaxEngine",
    "ExactEngine",
    "HybridEngine",
    "StreamEngine",
    "oracle_scores",
    "oracle_topk",
    "save_index",
    "load_index",
    "open_index",
    "Wal",
    "ShardedIndex",
    "save_sharded_index",
    "load_sharded_index",
    "open_sharded_index",
    "documents_from_texts",
    "tsvector",
]

# Where each public name lives in the port.
_HOME = {
    "Bm25Index": ".index.bm25index",
    "BoundQuery": ".index.bm25index",
    "SearchHit": ".index.bm25index",
    "Document": ".text.intern",
    "Query": ".text.intern",
    "random_seed": ".text.intern",
    "IndexOptions": ".utils.options",
    "SearchOptions": ".utils.options",
    "SessionConfig": ".utils.options",
    "build_sealed_segment": ".index.sealed",
    "build_sealed_segment_from_postings": ".index.sealed",
    "segment_from_reference": ".index.sealed",
    "BlockMaxEngine": ".search.blockmax",
    "ExactEngine": ".search.exact",
    "HybridEngine": ".search.hybrid",
    "StreamEngine": ".search.stream",
    "oracle_scores": ".search.exact",
    "oracle_topk": ".search.exact",
    "save_index": ".index.storage",
    "load_index": ".index.storage",
    "open_index": ".index.storage",
    "Wal": ".index.storage",
    "ShardedIndex": ".parallel.shard",
    "save_sharded_index": ".index.storage",
    "load_sharded_index": ".index.storage",
    "open_sharded_index": ".index.storage",
    "documents_from_texts": ".text.corpus",
    "tsvector": ".text.tokenizer",
}


def __getattr__(name):
    # Lazy, so importing the package loads no torch until a name needs it.
    import importlib

    if name in _HOME:
        return getattr(importlib.import_module(_HOME[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
