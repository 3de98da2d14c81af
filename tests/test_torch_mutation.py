"""``tests/test_mutation.py`` replayed on the port's ``Bm25Index`` with
``device="cpu"``: insert, delete, maintain, evaluate and the session limit.
Imports are rewritten and every assertion is the reference's; each test
that builds the reference's default engine runs on ``stream`` and on
``blockmax``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.options import SearchOptions, SessionConfig  # noqa: E402

from test_sealed import make_docs as make_ref_docs  # noqa: E402

torch.set_num_threads(2)


def make_docs(rng, n_docs, vocab=50, max_len=30):
    return [
        Document(keys=d.keys, values=d.values)
        for d in make_ref_docs(rng, n_docs, vocab=vocab, max_len=max_len)
    ]


def doc_of(ids):
    return Document.from_int_ids(ids)


@pytest.fixture(params=["stream", "blockmax"])
def build(request):
    def build(docs, **kw):
        return Bm25Index.build(docs, engine=request.param, device="cpu", **kw)

    return build


class TestInsert:
    def test_insert_visible_immediately(self, rng, build):
        docs = make_docs(rng, 20, vocab=10)
        index = build(docs)
        before = index.search(Query.from_int_ids([3]), k=50)
        index.insert(doc_of([3, 3, 4]), payload=999)
        after = index.search(Query.from_int_ids([3]), k=50)
        assert len(after) == len(before) + 1
        assert any(h.payload == 999 for h in after)

    def test_growing_uses_sealed_stats(self, rng, build):
        # A term present only in growing docs contributes nothing until
        # maintain (search.rs:53-79: token list comes from the sealed table).
        docs = make_docs(rng, 10, vocab=5)
        index = build(docs)
        index.insert(doc_of([777777]), payload=50)
        hits = index.search(Query.from_int_ids([777777]), k=10)
        assert hits == []
        index.maintain()
        hits = index.search(Query.from_int_ids([777777]), k=10)
        assert len(hits) == 1 and hits[0].payload == 50

    def test_insert_mixed_terms(self, rng, build):
        docs = make_docs(rng, 10, vocab=5)
        index = build(docs)
        # Doc with one sealed-known term and one unknown: only the known
        # term scores.
        index.insert(doc_of([0, 888888]), payload=77)
        hits = index.search(Query.from_int_ids([0, 888888]), k=50)
        assert any(h.payload == 77 for h in hits)


class TestDelete:
    def test_bulkdelete_sealed(self, rng, build):
        docs = make_docs(rng, 30, vocab=5)
        index = build(docs)
        n_before = len(index.search(Query.from_int_ids([0]), k=50))
        deleted = index.bulkdelete(lambda p: p < 15)
        assert deleted == 15
        hits = index.search(Query.from_int_ids([0]), k=50)
        assert all(h.payload >= 15 for h in hits)
        assert len(hits) <= n_before

    def test_bulkdelete_growing(self, rng, build):
        docs = make_docs(rng, 10, vocab=5)
        index = build(docs)
        index.insert(doc_of([0]), payload=1000)
        index.insert(doc_of([0]), payload=1001)
        assert index.bulkdelete(lambda p: p == 1000) == 1
        hits = index.search(Query.from_int_ids([0]), k=50)
        payloads = {h.payload for h in hits}
        assert 1000 not in payloads
        assert 1001 in payloads


class TestMaintain:
    def test_maintain_preserves_results(self, rng, build):
        docs = make_docs(rng, 50, vocab=8)
        index = build(docs)
        for i in range(5):
            index.insert(doc_of(rng.integers(0, 8, size=6).tolist()), 100 + i)
        index.bulkdelete(lambda p: p % 7 == 0)
        q = Query.from_int_ids([0, 1])
        before = index.search(q, k=30)
        index.maintain()
        assert len(index.growing) == 0
        after = index.search(q, k=30)
        # Same payload set (scores may shift: maintain folds growing docs
        # into the statistics, like the reference's vacuum).
        assert {h.payload for h in after} >= {
            h.payload for h in before if h.score > 1e-6
        } - {h.payload for h in before if h.score < 1e-6}

    def test_maintain_relabel_order(self, rng, build):
        # Live sealed docs keep slot order, growing docs append after
        # (maintain.rs pass A then pass C).
        docs = [doc_of([1]), doc_of([1]), doc_of([1])]
        index = build(docs, payloads=[10, 20, 30])
        index.bulkdelete(lambda p: p == 20)
        index.insert(doc_of([1]), payload=40)
        index.maintain()
        assert index.sealed.doc_payload.tolist() == [10, 30, 40]

    def test_maintain_empty(self, build):
        index = build([])
        index.maintain()
        assert index.n_docs == 0

    def test_counts(self, rng, build):
        docs = make_docs(rng, 20, vocab=5)
        index = build(docs)
        assert index.n_docs == 20
        index.insert(doc_of([0]), 100)
        assert index.n_docs == 21
        index.bulkdelete(lambda p: p == 0)
        assert index.n_docs == 20
        index.maintain()
        assert index.n_docs == 20
        assert index.sealed.n_docs == 20


class TestEvaluate:
    def test_evaluate_matches_search_scores(self, rng, build):
        docs = make_docs(rng, 30, vocab=10)
        index = build(docs)
        q = Query.from_int_ids([0, 1, 2])
        hits = index.search(q, k=10)
        for hit in hits:
            doc = docs[hit.payload]
            assert index.evaluate(doc, q) == pytest.approx(hit.score, rel=1e-4)

    def test_operator_score_negated(self, rng, build):
        docs = make_docs(rng, 10, vocab=5)
        index = build(docs)
        q = Query.from_int_ids([0])
        d = docs[0]
        assert index.operator_score(d, q) == -index.evaluate(d, q)

    def test_evaluate_unknown_terms_zero(self, rng, build):
        docs = make_docs(rng, 10, vocab=5)
        index = build(docs)
        assert index.evaluate(doc_of([999]), Query.from_int_ids([999])) == 0.0


class TestSessionLimit:
    def test_limit_resolution(self, rng, build):
        docs = make_docs(rng, 20, vocab=3)
        index = build(
            docs, search_options=SearchOptions(limit=5)
        )
        q = Query.from_int_ids([0])
        assert len(index.search(q)) <= 5
        session = SessionConfig(limit=2)
        assert len(index.search(q, session=session)) <= 2
        with pytest.raises(ValueError):
            build(docs).search(q)  # no limit anywhere
