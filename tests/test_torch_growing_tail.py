"""The growing segment's batch dispatch on the CPU: the host tail top-k
(``GrowingSegment._tail_topk``) held bit for bit to the dense ``[Q, tail]``
formulation it replaced, kept here as the oracle; the stream engine's
ids entry (``StreamEngine.search_ids_async``) held bit for bit to
``search_async``; a facade batch, for every engine and growing state,
that makes no ``Query`` object below the facade and looks the batch up
once; and the facade's one merge of sealed, growing-prefix and tail
results held to the per-query ``Bm25Index.search``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query, SearchOptions  # noqa: E402
from vectorchord_bm25_tpu_torch.search.stream import StreamEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.text import intern  # noqa: E402
from vectorchord_bm25_tpu_torch.utils import tracing  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup, group_positions  # noqa: E402

torch.set_num_threads(2)

K = 10
VOCAB = 40


@pytest.fixture(autouse=True)
def recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def dense_tail_topk(grow, ids, qidx, qn, k, keep):
    """The tail top-k as a dense [Q, tail] f32 matrix: every touched pair
    added with ``np.add.at`` in (query, doc, term) order, dropped columns
    zeroed, every row sorted in full.  Returns (scores, ids, pairs)."""
    n0 = grow._dev_engine_n
    tn = len(grow.documents) - n0
    m = min(k, tn)
    scores_out = np.full((qn, m), -np.inf, dtype=np.float64)
    idx_out = np.full((qn, m), -1, dtype=np.int64)
    if m == 0:
        return scores_out, idx_out, 0
    tids = np.concatenate(grow._tid[n0:])
    tfs = np.concatenate(grow._tf[n0:]).astype(np.float32)
    doc_of = np.repeat(np.arange(tn, dtype=np.int64), [t.size for t in grow._tid[n0:]])
    known = tids >= 0
    tids, tfs, doc_of = tids[known], tfs[known], doc_of[known]
    order = np.argsort(tids, kind="stable")
    tids, tfs, doc_of = tids[order], tfs[order], doc_of[order]
    if tids.size == 0 or ids.size == 0:
        return scores_out, idx_out, 0
    s0 = grow.sealed.token_s0().astype(np.float32)
    fn = np.asarray(grow.fieldnorms, dtype=np.int64)[n0 + doc_of]
    s1 = grow.sealed.score_tables().s1_table[fn].astype(np.float32)
    impact = ((tfs * s0[tids]) / (tfs + s1)).astype(np.float32)
    lo = np.searchsorted(tids, ids, side="left")
    cnt = np.searchsorted(tids, ids, side="right") - lo
    if int(cnt.sum()) == 0:
        return scores_out, idx_out, 0
    src = np.repeat(lo, cnt) + group_positions(cnt)
    q_of, d, imp, t_of = np.repeat(qidx, cnt), doc_of[src], impact[src], tids[src]
    acc_order = np.lexsort((t_of, d, q_of))
    dense = np.zeros((qn, tn), dtype=np.float32)
    np.add.at(dense, (q_of[acc_order], d[acc_order]), imp[acc_order])
    drop = np.asarray(grow.deleted[n0:], dtype=bool)
    if keep is not None:
        drop = drop | ~np.asarray(keep, dtype=bool)[n0:]
    dense[:, drop] = 0.0
    top = np.argsort(-dense, axis=1, kind="stable")[:, :m]
    s = np.take_along_axis(dense, top, axis=1).astype(np.float64)
    live = s > 0.0
    scores_out[live] = s[live]
    idx_out[live] = (top + n0)[live]
    return scores_out, idx_out, int(src.size)


def grow_topk(grow, queries, k, keep=None):
    """The growing segment's blocks for ``queries``, looked up as the
    facade looks them up."""
    ids, qidx = batch_lookup(grow.sealed.lookup_tokens, queries)
    return grow.topk_batch_async(ids, qidx, len(queries), k, keep)()


def tail_docs(rng, case):
    """The tail's documents for ``case``."""
    if case == "empty":
        return []
    if case == "one":
        return [Document.from_int_ids([1, 2, 2, 5])]
    if case == "under_k":
        return [Document.from_int_ids(rng.integers(0, VOCAB, 8).tolist()) for _ in range(4)]
    if case == "ties":
        # Identical docs score identically: ids break the ties.
        same = [3, 3, 7, 11]
        return [Document.from_int_ids(same) for _ in range(14)] + [
            Document.from_int_ids([3, 7, 20, 21]) for _ in range(6)
        ]
    if case == "repeated_term":
        # Term 1 in every tail doc, with the length varying the score.
        return [
            Document.from_int_ids([1] + rng.integers(0, VOCAB, int(rng.integers(0, 25))).tolist())
            for _ in range(60)
        ]
    # "over_k"
    return [
        Document.from_int_ids(rng.integers(0, VOCAB, int(rng.integers(1, 30))).tolist())
        for _ in range(50)
    ]


def growing_with_tail(case, seed=3):
    rng = np.random.default_rng(seed)
    docs = [
        Document.from_int_ids(rng.integers(0, VOCAB, int(rng.integers(1, 30))).tolist())
        for _ in range(200)
    ]
    idx = Bm25Index.build(docs, device="cpu")
    for j in range(30):
        idx.insert(Document.from_int_ids(rng.integers(0, VOCAB, 10).tolist()), 1000 + j)
    grow = idx.growing
    grow_topk(grow, [Query.from_int_ids([1])], K)  # the engine holds 30 docs
    for j, doc in enumerate(tail_docs(rng, case)):
        idx.insert(doc, 2000 + j)
    return idx, grow, rng


def batch(rng, n=24):
    qs = [Query.from_int_ids(rng.integers(0, VOCAB, int(rng.integers(1, 6))).tolist()) for _ in range(n)]
    qs.append(Query.from_int_ids([10_000, 10_001]))  # no known term
    qs.append(Query.from_int_ids([]))  # no term at all
    qs.append(Query.from_int_ids([1]))
    qs.append(Query.from_int_ids([3, 7, 11]))
    return qs


CASES = ["empty", "one", "under_k", "over_k", "ties", "repeated_term"]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("deleted", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_tail_topk_equals_dense_oracle(case, deleted, filtered):
    idx, grow, rng = growing_with_tail(case)
    n0, g = grow._dev_engine_n, len(grow)
    assert n0 == 30
    if deleted and g > n0:
        mask = np.zeros(g, dtype=bool)
        mask[n0 + rng.choice(g - n0, max(1, (g - n0) // 3), replace=False)] = True
        mask[rng.choice(n0, 5, replace=False)] = True
        grow.apply_delete_mask(mask)
    keep = rng.random(g) < 0.6 if filtered else None
    queries = batch(rng)
    ids, qidx = batch_lookup(grow.sealed.lookup_tokens, queries)
    tracing.enable()
    got = grow._tail_topk(ids, qidx, len(queries), K, keep)
    want = dense_tail_topk(grow, ids, qidx, len(queries), K, keep)
    assert got[0].dtype == np.float64 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == (len(queries), min(K, g - n0))
    pairs = want[2]
    assert tracing.snapshot()["counters"].get("growing_tail_pairs", 0) == pairs
    if case in ("over_k", "ties", "repeated_term"):
        assert pairs > 0 and (got[1] >= n0).any()
    if case == "ties" and not (deleted or filtered):
        # The last query's 10 best are 10 of the 14 identical docs: one
        # score, ranked by id.
        assert np.unique(got[0][-1]).size == 1
        assert (got[1][-1] == n0 + np.arange(K)).all()


@pytest.mark.parametrize("k", [1, 3, 100])
def test_tail_topk_at_any_k(k):
    idx, grow, rng = growing_with_tail("over_k", seed=9)
    queries = batch(rng)
    ids, qidx = batch_lookup(grow.sealed.lookup_tokens, queries)
    got = grow._tail_topk(ids, qidx, len(queries), k, None)
    want = dense_tail_topk(grow, ids, qidx, len(queries), k, None)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def sealed_engine(strategy, n=600, seed=4):
    rng = np.random.default_rng(seed)
    docs = [
        Document.from_int_ids(rng.integers(0, 120, int(rng.integers(1, 40))).tolist())
        for _ in range(n)
    ]
    seg = Bm25Index.build(docs, device="cpu").sealed
    return StreamEngine(seg, device="cpu", strategy=strategy), rng


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("strategy", ["dense", "sparse", "maxscore", "auto"])
def test_search_ids_async_equals_search_async(strategy, filtered):
    engine, rng = sealed_engine(strategy)
    queries = [Query.from_int_ids(rng.integers(0, 130, int(rng.integers(1, 6))).tolist()) for _ in range(40)]
    queries += [Query.from_int_ids([]), Query.from_int_ids([5000])]
    fm = (rng.random(engine.n_docs) < 0.7).astype(np.float32) if filtered else None
    want = engine.search_async(queries, K, filter_mask=fm)()
    ids, qidx = batch_lookup(engine.segment.lookup_tokens, queries)
    got = engine.search_ids_async(ids, qidx, len(queries), K, filter_mask=fm)()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(want[0]).any()


def hits_of(result):
    return [[(h.score, h.payload) for h in hits] for hits in result]


def facade_index(engine, options, growing, seed=5):
    """A 600-doc sealed segment served by ``engine`` and a growing segment
    that is empty ("empty"), all in its device engine ("prefix"), or 30
    docs there and 20 in the host tail ("prefix_tail")."""
    rng = np.random.default_rng(seed)

    def docs(n):
        return [Document.from_int_ids(rng.integers(0, VOCAB, int(rng.integers(1, 30))).tolist()) for _ in range(n)]

    idx = Bm25Index.build(docs(600), engine=engine, engine_options=options, device="cpu")
    if growing != "empty":
        for j, doc in enumerate(docs(30)):
            idx.insert(doc, 1000 + j)
        idx.search_batch_async([Query.from_int_ids([1])], K)()  # the engine holds 30 docs
    if growing == "prefix_tail":
        for j, doc in enumerate(docs(20)):
            idx.insert(doc, 2000 + j)
    return idx, rng


ENGINES = {
    "stream": ("stream", {}),
    "blockmax": ("blockmax", {"chunk": 2}),
    "exact": ("exact", {}),
    "hybrid": ("hybrid", {"oneshot_cap": 8, "heavy_mode": "pruned"}),
    "maxscore": ("stream", {"strategy": "maxscore"}),
    "auto_routed": ("stream", {}),
}


def at_scale(monkeypatch, case):
    """For "auto_routed", 'auto' past its sparse crossover with a router
    that sends the queries matching 6 windows or more to MaxScore."""
    if case == "auto_routed":
        monkeypatch.setattr(StreamEngine, "SPARSE_MIN_DOCS", 64)
        monkeypatch.setattr(StreamEngine, "MS_ROUTE_FRAC", 1.0)
        monkeypatch.setattr(StreamEngine, "MS_ROUTE_MIN_WINDOWS", 6)


@pytest.mark.parametrize("growing", ["empty", "prefix", "prefix_tail"])
@pytest.mark.parametrize("case", sorted(ENGINES))
def test_growing_dispatch_makes_no_query_and_one_lookup(monkeypatch, case, growing):
    at_scale(monkeypatch, case)
    engine, options = ENGINES[case]
    idx, rng = facade_index(engine, options, growing)
    grow = idx.growing
    assert len(grow) - grow._dev_engine_n == (20 if growing == "prefix_tail" else 0)
    queries = batch(rng)
    want = hits_of(idx.search_batch_async(queries, K)())
    made = []
    post_init = intern.Query.__post_init__

    def counted(self):
        made.append(1)
        post_init(self)

    lookups = []
    sealed_lookup = idx.sealed.lookup_tokens
    monkeypatch.setattr(intern.Query, "__post_init__", counted)
    monkeypatch.setattr(idx.sealed, "lookup_tokens", lambda keys: lookups.append(keys.size) or sealed_lookup(keys))
    if grow._dev_engine is not None:
        engine_lookup = grow._dev_engine.segment.lookup_tokens
        monkeypatch.setattr(
            grow._dev_engine.segment, "lookup_tokens", lambda keys: lookups.append(-1) or engine_lookup(keys)
        )
    got = hits_of(idx.search_batch_async(queries, K)())
    assert made == [] and lookups == [sum(len(q) for q in queries)]
    assert got == want and any(got)
    if case in ("maxscore", "auto_routed"):
        stats = idx.engine().last_ms_stats
        assert stats["batch_queries"] == len(queries) and stats["tiers"]
        routed = stats["routed_queries"]
        assert routed == len(queries) if case == "maxscore" else 0 < routed < len(queries)


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_one_merge_equals_per_query_search(monkeypatch, case):
    # Sealed, growing prefix and tail all hold hits, some docs of each
    # deleted, under a prefilter: every row of the batch is the per-query
    # path's list, which merges by its own sort.
    at_scale(monkeypatch, case)
    engine, options = ENGINES[case]
    idx, rng = facade_index(engine, options, "prefix_tail", seed=8)
    idx.search_options = SearchOptions(prefilter=True)
    grow = idx.growing
    assert grow._dev_engine_n == 30 and len(grow) == 50
    idx.bulkdelete_payloads([3, 17, 250, 1002, 1011, 2004, 2013])
    keep = lambda p: p % 5 != 1  # noqa: E731
    queries = batch(rng, n=40)
    rows = idx.search_batch_async(queries, K, filter_fn=keep)()
    assert rows == [idx.search(q, k=K, filter_fn=keep) for q in queries]
    payloads = {h.payload for hits in rows for h in hits}
    assert min(payloads) < 1000 and any(1000 <= p < 1030 for p in payloads) and max(payloads) >= 2000
    assert not payloads & {3, 17, 250, 1002, 1011, 2004, 2013} and all(keep(p) for p in payloads)
