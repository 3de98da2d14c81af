"""``tests/test_prefilter.py`` replayed on the port's ``Bm25Index`` with
``device="cpu"``: prefilter vs post-filter semantics (the reference's
prefilter reloption, tests/sqllogictest/prefilter.slt behavior).  Imports
are rewritten and every assertion is the reference's; each test that
builds the reference's default engine runs on ``stream`` and on
``blockmax``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.options import SearchOptions, SessionConfig  # noqa: E402

from test_torch_mutation import build, make_docs  # noqa: E402,F401

torch.set_num_threads(2)


def test_prefilter_keeps_threshold_honest(rng, build):
    # Corpus where the best-scoring docs fail the filter: prefilter must
    # surface k *matching* docs; post-filter returns fewer.
    docs = []
    for i in range(100):
        # Even docs: short (high score); odd docs: long (low score).
        extra = [] if i % 2 == 0 else rng.integers(10, 50, size=30).tolist()
        docs.append(Document.from_int_ids([0] + extra))
    q = Query.from_int_ids([0])
    only_odd = lambda p: p % 2 == 1  # noqa: E731

    pre = build(
        docs, search_options=SearchOptions(prefilter=True)
    )
    hits_pre = pre.search(q, k=10, filter_fn=only_odd)
    assert len(hits_pre) == 10
    assert all(h.payload % 2 == 1 for h in hits_pre)

    post = build(
        docs, search_options=SearchOptions(prefilter=False)
    )
    hits_post = post.search(q, k=10, filter_fn=only_odd)
    # All top-10 unfiltered hits are even (short) docs -> all filtered out.
    assert len(hits_post) == 0


def test_enable_scan_off_uses_brute_force(rng, build):
    # bm25.enable_scan = off routes through the exact brute-force path;
    # results match the index scan up to float ties.
    docs = make_docs(rng, 80, vocab=6)
    index = build(docs)
    q = Query.from_int_ids([0, 1])
    on = index.search(q, k=10)
    off = index.search(q, k=10, session=SessionConfig(enable_scan=False))
    assert {h.payload for h in on} == {h.payload for h in off}
    for a, b in zip(on, off):
        assert abs(a.score - b.score) < 1e-4


def test_session_override(rng, build):
    docs = make_docs(rng, 50, vocab=4)
    index = build(
        docs, search_options=SearchOptions(prefilter=False)
    )
    q = Query.from_int_ids([0])
    session = SessionConfig(prefilter=True)
    hits = index.search(q, k=5, filter_fn=lambda p: p >= 25, session=session)
    assert all(h.payload >= 25 for h in hits)


def test_prefilter_batch_path(rng, build):
    """search_batch honors pre/post-filter semantics like search (the
    batched filtered-search API)."""
    docs = []
    for i in range(100):
        extra = [] if i % 2 == 0 else rng.integers(10, 50, size=30).tolist()
        docs.append(Document.from_int_ids([0] + extra))
    queries = [Query.from_int_ids([0]) for _ in range(8)]
    only_odd = lambda p: p % 2 == 1  # noqa: E731

    pre = build(
        docs, search_options=SearchOptions(prefilter=True)
    )
    rows = pre.search_batch(queries, k=10, filter_fn=only_odd)
    for hits in rows:
        assert len(hits) == 10
        assert all(h.payload % 2 == 1 for h in hits)
        single = pre.search(queries[0], k=10, filter_fn=only_odd)
        assert [h.payload for h in hits] == [h.payload for h in single]

    post = build(
        docs, search_options=SearchOptions(prefilter=False)
    )
    rows = post.search_batch(queries, k=10, filter_fn=only_odd)
    assert all(len(hits) == 0 for hits in rows)


def test_prefilter_vectorized_at_scale():
    """Prefiltered search on a 1M-doc index runs in milliseconds per query
    batch — the mask comes from one vectorized predicate evaluation (and
    is cached), never an O(N) Python loop per search."""
    import time

    from vectorchord_bm25_tpu_torch.index.sealed import (
        build_sealed_segment_from_postings,
    )

    n_docs = 1_000_000
    g = np.random.default_rng(5)
    lengths = g.integers(3, 9, size=n_docs)
    total = int(lengths.sum())
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    ids = g.integers(0, 30_000, size=total)
    order = np.lexsort((ids, doc_of))
    d_s, i_s = doc_of[order], ids[order]
    keep = np.ones(total, dtype=bool)
    keep[1:] = (d_s[1:] != d_s[:-1]) | (i_s[1:] != i_s[:-1])
    kb = np.zeros((int(keep.sum()), 16), dtype=np.uint8)
    kb[:, :4] = i_s[keep].astype(">u4").view(np.uint8).reshape(-1, 4)
    seg = build_sealed_segment_from_postings(
        kb.reshape(-1).view("S16"), d_s[keep],
        np.ones(int(keep.sum()), dtype=np.int64), n_docs,
        doc_grouped=True,
    )
    from vectorchord_bm25_tpu_torch.text.intern import random_seed
    from vectorchord_bm25_tpu_torch.utils.options import IndexOptions

    idx = Bm25Index(
        seg, random_seed(), IndexOptions(),
        search_options=SearchOptions(prefilter=True), engine="exact",
        device="cpu",
    )
    q = Query.from_int_ids([7, 11])
    pred = lambda p: p % 3 == 0  # noqa: E731
    idx.search(q, k=10, filter_fn=pred)  # first call + mask build + cache
    t0 = time.perf_counter()
    for _ in range(5):
        hits = idx.search(q, k=10, filter_fn=pred)
    dt = (time.perf_counter() - t0) / 5
    assert all(h.payload % 3 == 0 for h in hits)
    # An O(N) Python predicate loop costs ~1 s/query at 1M docs; the
    # vectorized+cached mask path must be hundredths of that.
    assert dt < 0.25, f"filtered search took {dt:.3f}s per query"
