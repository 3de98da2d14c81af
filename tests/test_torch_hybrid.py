"""The port's hybrid engine against the reference's, on the CPU.

Replays of ``tests/test_hybrid.py`` and ``tests/test_lazy_hybrid.py`` on
the port, each also held to the reference ``HybridEngine`` on the same
segment and queries, whose Block-Max engine runs the Pallas kernel in
interpret mode (``use_pallas="interpret"``); the port takes the same option
and ignores it.  Every heavy mode and both memory modes; the facade's
``engine="hybrid"``; ``from_reference``.

Tolerance: ids equal and scores equal bit for bit (every route adds a doc's
terms in ascending term order); ``memory_report()`` dicts equal, the lazy
``projected`` one included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.search.hybrid import HybridEngine as RefHybrid  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document, Query, random_seed  # noqa: E402
from vectorchord_bm25_tpu.utils.options import SessionConfig  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference  # noqa: E402
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.search.exact import ExactEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.search.hybrid import HybridEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import (  # noqa: E402
    batch_lookup,
    group_positions,
)

from test_exact import rank_match  # noqa: E402
from test_sealed import make_docs  # noqa: E402


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


torch.set_num_threads(2)

HEAVY_MODES = ["auto", "exact", "pruned", "rangescan"]
MEMORY_MODES = ["fast", "compact"]


def both(seg, **opts):
    """(reference engine, port engine on the CPU) over one segment, the
    reference's Block-Max on the Pallas kernel in interpret mode."""
    opts = {"use_pallas": "interpret", **opts}
    return RefHybrid(seg, **opts), HybridEngine(
        segment_from_reference(seg), device="cpu", **opts
    )


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def split_corpus(rng):
    """tests/test_hybrid.py's corpus: a very common term (0) and rare ones,
    so the router actually splits the batch."""
    docs = make_docs(rng, 400, vocab=40)
    for i in range(0, 400, 2):
        docs[i] = Document.from_int_ids([0] + rng.integers(1, 40, size=5).tolist())
    docs[3] = Document.from_int_ids([1000, 1001])
    docs[7] = Document.from_int_ids([1000, 2])
    queries = [
        Query.from_int_ids([0]),  # heavy: df ~ half the corpus
        Query.from_int_ids([0, 17]),  # heavy
        Query.from_int_ids([1000]),  # light: df = 2 -> one-shot
        Query.from_int_ids([1000, 1001]),  # light -> one-shot
        Query.from_int_ids([17]),  # df under the budget, every range -> dense
        Query.from_int_ids([999999]),  # absent -> dense
        Query(keys=np.zeros(0, dtype="S16")),
    ]
    return build_sealed_segment(docs), queries


# --- replay of tests/test_hybrid.py


def test_hybrid_matches_exact(rng):
    seg, queries = split_corpus(rng)
    queries = queries[:4]
    pseg = segment_from_reference(seg)
    exact = ExactEngine(pseg, device="cpu")
    hybrid = HybridEngine(pseg, route_threshold=0.10, chunk=8, device="cpu")
    strategy, ranges = hybrid._route(*looked_up(hybrid, queries))
    # Heavy queries take the iterative pruned path; selective ones don't.
    assert strategy.tolist()[:2] == [2, 2]
    assert all(s != 2 for s in strategy.tolist()[2:])
    # With a forced one-shot cap, selective queries one-shot instead, and
    # results are identical.
    hybrid_os = HybridEngine(pseg, route_threshold=0.10, oneshot_cap=64, device="cpu")
    strategy2, _ = hybrid_os._route(*looked_up(hybrid_os, queries))
    assert strategy2.tolist()[2:] == [0, 0]
    s1_, i1, p1 = hybrid_os.search(queries, 15)
    s0_, i0, p0 = hybrid.search(queries, 15)
    np.testing.assert_array_equal(i0, i1)

    s1_, i1, p1 = exact.search(queries, 15)
    s2_, i2, p2 = hybrid.search(queries, 15)
    for qi in range(len(queries)):
        g1, g2 = i1[qi][i1[qi] >= 0], i2[qi][i2[qi] >= 0]
        assert len(g1) == len(g2)
        rank_match(g2, g1, s2_[qi][: len(g2)], s1_[qi][: len(g1)])


def test_hybrid_deletes_and_filter(rng):
    seg = segment_from_reference(build_sealed_segment(make_docs(rng, 100, vocab=6)))
    hybrid = HybridEngine(seg, route_threshold=0.01, chunk=4, device="cpu")  # all heavy
    exact = ExactEngine(seg, device="cpu")
    deleted = np.zeros(100, dtype=bool)
    deleted[:30] = True
    hybrid.set_deleted(deleted)
    exact.set_deleted(deleted)
    mask = np.zeros(100, dtype=bool)
    mask[40:] = True
    q = [Query.from_int_ids([0, 1])]
    s1_, i1, _ = exact.search(q, 10, filter_mask=mask)
    s2_, i2, _ = hybrid.search(q, 10, filter_mask=mask)
    g1, g2 = i1[0][i1[0] >= 0], i2[0][i2[0] >= 0]
    assert len(g1) == len(g2) > 0
    rank_match(g2, g1, s2_[0][: len(g2)], s1_[0][: len(g1)])


# --- every heavy mode and memory mode against the reference engine


@pytest.mark.parametrize("memory_mode", MEMORY_MODES)
@pytest.mark.parametrize("heavy_mode", HEAVY_MODES)
def test_routes_equal_reference(rng, heavy_mode, memory_mode):
    seg, queries = split_corpus(rng)
    opts = dict(
        route_threshold=0.10, chunk=8, oneshot_cap=2, heavy_mode=heavy_mode,
        memory_mode=memory_mode,
    )
    ref, port = both(seg, **opts)
    assert port.memory_report() == ref.memory_report()  # nothing built yet
    strategy, ranges = port._route(*looked_up(port, queries))
    ref_strategy, ref_ranges = ref._route(queries)
    np.testing.assert_array_equal(strategy, ref_strategy)
    np.testing.assert_array_equal(ranges, ref_ranges)
    assert set(strategy.tolist()) == {0, 1, 2}  # every route is taken
    for k in (3, 15, 1000):
        assert_same(port.search(queries, k), ref.search(queries, k))
    deleted = rng.random(seg.n_docs) < 0.2
    fmask = rng.random(seg.n_docs) < 0.7
    port.set_deleted(deleted)
    ref.set_deleted(deleted)
    got = port.search(queries, 15, filter_mask=fmask)
    assert_same(got, ref.search(queries, 15, filter_mask=fmask))
    assert (got[1] >= 0).any() and not (deleted | ~fmask)[got[1][got[1] >= 0]].any()
    assert port.memory_report() == ref.memory_report()
    # Which engines were built, and whether they share one copy.
    assert (port._blockmax is None) == (ref._blockmax is None)
    assert port._blockmax is not None  # the one-shot group needs it
    assert (port.exact.dev is port.blockmax.dev) == (memory_mode == "compact")
    if memory_mode == "compact":
        assert port.exact.dev_post_impact.data_ptr() == port.blockmax.dev_post_impact.data_ptr()
        assert "dense_strategy_bytes" not in port.memory_report()
    else:
        assert port.memory_report()["dense_strategy_bytes"] > 0


def test_tf_postings_heavy_route(rng):
    # P1-tf through the hybrid engine: posting_mode="tf", pruned heavy mode.
    seg, queries = split_corpus(rng)
    opts = dict(
        route_threshold=0.10, chunk=8, oneshot_cap=2, heavy_mode="pruned",
        posting_mode="tf",
    )
    ref, port = both(seg, **{**opts, "use_pallas": None})
    assert set(port._route(*looked_up(port, queries))[0].tolist()) == {0, 1, 2}
    assert_same(port.search(queries, 15), ref.search(queries, 15))
    assert port.blockmax.posting_mode == "tf"
    assert port.memory_report() == ref.memory_report()


def test_constructor_checks(rng):
    seg = segment_from_reference(build_sealed_segment(make_docs(rng, 30, vocab=5)))
    with pytest.raises(ValueError, match="unknown memory_mode"):
        HybridEngine(seg, memory_mode="tiny", device="cpu")
    with pytest.raises(ValueError, match="unknown heavy_mode"):
        HybridEngine(seg, heavy_mode="none", device="cpu")
    with pytest.raises(ValueError, match="shares impact arrays"):
        HybridEngine(seg, memory_mode="compact", posting_mode="tf", device="cpu")
    with pytest.raises(ValueError, match="number of needed rows"):
        HybridEngine(seg, device="cpu").search([Query.from_int_ids([0])], 0)


def test_from_reference_copies_state(rng):
    seg, queries = split_corpus(rng)
    ref = RefHybrid(
        seg, route_threshold=0.05, chunk=8, oneshot_cap=64, heavy_mode="pruned",
        memory_mode="compact", use_pallas="interpret",
    )
    deleted = rng.random(seg.n_docs) < 0.2
    ref.set_deleted(deleted)
    port = HybridEngine.from_reference(ref, device="cpu")
    assert port.segment is not seg and port.ranges is not ref.ranges
    assert (port.heavy_mode, port.memory_mode, port.oneshot_cap, port.route_threshold) == (
        "pruned", "compact", 64, 0.05,
    )
    assert port._blockmax is None and port._exact is None  # still lazy
    assert_same(port.search(queries, 15), ref.search(queries, 15))
    assert port.memory_report() == ref.memory_report()
    port = HybridEngine.from_reference(seg, device="cpu", deleted=deleted, oneshot_cap=64)
    assert_same(port.search(queries, 15), ref.search(queries, 15))


# --- replay of tests/test_lazy_hybrid.py


def test_default_search_never_builds_blockmax(rng):
    seg = build_sealed_segment(make_docs(rng, 150, vocab=8))
    ref, h = both(seg)  # heavy_mode auto -> exact
    queries = [
        Query.from_int_ids(rng.integers(0, 8, size=3).tolist()) for _ in range(8)
    ] + [Query.from_int_ids([999999]), Query(keys=np.zeros(0, dtype="S16"))]
    got = h.search(queries, 5)
    assert h._blockmax is None  # pruned arrays never uploaded
    assert_same(got, ref.search(queries, 5))


def test_memory_report_does_not_construct(rng):
    seg = build_sealed_segment(make_docs(rng, 80, vocab=6))
    ref, h = both(seg)
    rep = h.memory_report()
    assert rep.get("projected") is True
    assert rep == ref.memory_report()
    assert h._exact is None and h._blockmax is None
    # After a search the report reflects the real upload.
    h.search([Query.from_int_ids([1])], 3)
    rep2 = h.memory_report()
    assert "projected" not in rep2
    # The projection matched the real dense upload exactly.
    assert rep["total"] == rep2["total"]


def test_pruned_mode_builds_blockmax_on_demand(rng):
    seg = build_sealed_segment(make_docs(rng, 100, vocab=4))  # tiny vocab -> heavy queries
    ref, h = both(seg, heavy_mode="pruned")
    got = h.search([Query.from_int_ids([0, 1])], 5)
    assert type(h._blockmax) is BlockMaxEngine
    assert_same(got, ref.search([Query.from_int_ids([0, 1])], 5))


def test_set_deleted_before_lazy_build_applies(rng):
    docs = make_docs(rng, 60, vocab=4)
    ref, h = both(build_sealed_segment(docs), heavy_mode="pruned")
    deleted = np.zeros(len(docs), dtype=bool)
    deleted[:30] = True
    h.set_deleted(deleted)  # neither engine constructed yet
    ref.set_deleted(deleted)
    s, ids, _ = h.search([Query.from_int_ids([0, 1, 2])], 10)
    assert (ids[0] >= 0).any()
    for d in ids[0][ids[0] >= 0]:
        assert not deleted[d]
    assert_same((s, ids), ref.search([Query.from_int_ids([0, 1, 2])], 10)[:2])


def test_batch_lookup_matches_per_query(rng):
    seg = segment_from_reference(build_sealed_segment(make_docs(rng, 90, vocab=12)))
    queries = [
        Query.from_int_ids(rng.integers(0, 20, size=4).tolist()) for _ in range(9)
    ] + [Query(keys=np.zeros(0, dtype="S16"))]
    ids, qidx = batch_lookup(seg.lookup_tokens, queries)
    for qi, q in enumerate(queries):
        expect = seg.lookup_tokens(q.keys)
        expect = expect[expect >= 0]
        got = ids[qidx == qi]
        np.testing.assert_array_equal(np.sort(got), np.sort(expect))


def test_group_positions():
    np.testing.assert_array_equal(
        group_positions(np.array([3, 0, 2])), [0, 1, 2, 0, 1]
    )
    assert group_positions(np.array([], dtype=np.int64)).size == 0


# --- the facade


def hits_of(results):
    return [[(h.score, h.payload) for h in hits] for hits in results]


@pytest.mark.parametrize(
    "opts",
    [
        {},
        {"heavy_mode": "pruned", "memory_mode": "compact", "oneshot_cap": 64, "chunk": 8},
        {"heavy_mode": "rangescan", "oneshot_cap": 64},
    ],
    ids=["default", "pruned-compact", "rangescan"],
)
def test_facade_hybrid(rng, opts):
    # build, search_batch, search, bulkdelete, prefilter, insert and
    # maintain through engine="hybrid", against the reference facade.
    seg, queries = split_corpus(rng)
    docs = make_docs(rng, 400, vocab=40)
    for i in range(0, 400, 2):
        docs[i] = Document.from_int_ids([0] + rng.integers(1, 40, size=5).tolist())
    docs[3] = Document.from_int_ids([1000, 1001])
    seed = random_seed()
    payloads = (np.arange(400, dtype=np.int64) * 3 + 11).tolist()
    ref_opts = {"use_pallas": "interpret", **opts}
    ref = RefIndex.build(docs, payloads=payloads, seed=seed, engine="hybrid", engine_options=ref_opts)
    port = Bm25Index.build(
        docs, payloads=payloads, seed=seed, engine="hybrid", engine_options=ref_opts,
        device="cpu",
    )
    assert type(port.engine()) is HybridEngine
    assert hits_of(port.search_batch(queries, 10)) == hits_of(ref.search_batch(queries, 10))
    for q in queries[:4]:
        assert hits_of([port.search(q, k=5)]) == hits_of([ref.search(q, k=5)])
    assert port.bulkdelete(lambda p: p % 7 == 0) == ref.bulkdelete(lambda p: p % 7 == 0) > 0
    sess = SessionConfig(prefilter=True)
    got = hits_of(port.search_batch(queries, 10, filter_fn=lambda p: p % 2 == 1, session=sess))
    assert got == hits_of(
        ref.search_batch(queries, 10, filter_fn=lambda p: p % 2 == 1, session=sess)
    )
    assert sum(map(len, got)) and all(p % 2 and p % 7 for hits in got for _, p in hits)
    for i, doc in enumerate(make_docs(rng, 20, vocab=40)):
        ref.insert(doc, 100_000 + i)
        port.insert(doc, 100_000 + i)
    assert hits_of(port.search_batch(queries, 10)) == hits_of(ref.search_batch(queries, 10))
    ref.maintain()
    port.maintain()
    assert hits_of(port.search_batch(queries, 10)) == hits_of(ref.search_batch(queries, 10))
    assert port.engine().memory_report() == ref.engine().memory_report()
