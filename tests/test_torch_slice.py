"""The port's facade vs the reference facade, for each ported engine.

Same corpus, same seed, same operations on both; the reference serves
with its Pallas kernel in interpret mode (engine="blockmax") or its jnp
kernels on the CPU (engine="stream", the default), the port on the CPU
through the plain versions of its kernels.  Payloads and scores must be
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.bm25index import (  # noqa: E402
    Bm25Index as RefIndex,
)
from vectorchord_bm25_tpu.index.storage import load_index, save_index  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document, Query, random_seed  # noqa: E402
from vectorchord_bm25_tpu.text.tokenizer import tsvector  # noqa: E402
from vectorchord_bm25_tpu.utils.options import SessionConfig  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402

from test_sealed import make_docs  # noqa: E402
from test_tokenizer import TOY_CORPUS  # noqa: E402

torch.set_num_threads(2)

N_DOCS, VOCAB = 2048, 300
# chunk=4: several pruning rounds per batch on this corpus (16 ranges).  The
# port takes the reference's options as they are: it accepts use_pallas and
# ignores it (the tensors' device picks the kernel).
REF_OPTS = {"use_pallas": "interpret", "chunk": 4}


def hits_of(results):
    """[[(score, payload), ...], ...] of search_batch / search results."""
    return [[(h.score, h.payload) for h in hits] for hits in results]


@pytest.fixture
def corpus(rng):
    docs = make_docs(rng, N_DOCS, vocab=VOCAB)
    payloads = (np.arange(N_DOCS, dtype=np.int64) * 3 + 11).tolist()
    queries = [
        Query.from_int_ids(rng.integers(0, VOCAB, size=int(n)).tolist())
        for n in rng.integers(1, 6, size=64)
    ]
    return docs, payloads, queries


@pytest.fixture
def pair(corpus):
    docs, payloads, queries = corpus
    seed = random_seed()
    ref = RefIndex.build(
        docs, payloads=payloads, seed=seed, engine="blockmax",
        engine_options=REF_OPTS,
    )
    port = Bm25Index.build(
        docs, payloads=payloads, seed=seed, engine="blockmax",
        engine_options=REF_OPTS, device="cpu",
    )
    return ref, port, queries


@pytest.fixture
def stream_pair(corpus):
    # Both facades with their default engine (stream, dense below 2^21 docs).
    docs, payloads, queries = corpus
    seed = random_seed()
    ref = RefIndex.build(docs, payloads=payloads, seed=seed)
    port = Bm25Index.build(docs, payloads=payloads, seed=seed, device="cpu")
    assert ref.engine_kind == port.engine_kind == "stream"
    return ref, port, queries


def assert_batch_equal(ref, port, queries, k=10, **kw):
    want = hits_of(ref.search_batch(queries, k, **kw))
    got = hits_of(port.search_batch(queries, k, **kw))
    assert got == want
    assert sum(map(len, got)) > 0
    return got


def test_search_batch(pair):
    ref, port, queries = pair
    assert_batch_equal(ref, port, queries)
    assert_batch_equal(ref, port, queries, k=3)


def test_search_single(pair):
    ref, port, queries = pair
    for q in queries[:8]:
        assert hits_of([port.search(q, k=10)]) == hits_of([ref.search(q, k=10)])


def test_bulkdelete(pair):
    ref, port, queries = pair

    def pred(p):
        return p % 7 == 0

    assert port.bulkdelete(pred) == ref.bulkdelete(pred) > 0
    got = assert_batch_equal(ref, port, queries)
    assert all(p % 7 for hits in got for _, p in hits)


def test_prefilter(pair):
    ref, port, queries = pair
    sess = SessionConfig(prefilter=True)

    def keep(p):
        return p % 2 == 1

    got = assert_batch_equal(ref, port, queries, filter_fn=keep, session=sess)
    assert all(p % 2 for hits in got for _, p in hits)


def test_insert_maintain_search_batch(pair, rng):
    ref, port, queries = pair
    new = make_docs(rng, 40, vocab=VOCAB)
    for i, doc in enumerate(new):
        ref.insert(doc, 100_000 + i)
        port.insert(doc, 100_000 + i)
    # Growing docs: single-query search on the host, search_batch through
    # the growing segment's stream engine.
    for q in queries[:4]:
        assert hits_of([port.search(q, k=10)]) == hits_of([ref.search(q, k=10)])
    got = assert_batch_equal(ref, port, queries)
    assert any(p >= 100_000 for hits in got for _, p in hits)
    ref.bulkdelete(lambda p: p % 5 == 0)
    port.bulkdelete(lambda p: p % 5 == 0)
    ref.maintain()
    port.maintain()
    got = assert_batch_equal(ref, port, queries)
    assert any(p >= 100_000 for hits in got for _, p in hits)


def test_readme_toy_anchor():
    seed = random_seed()
    docs = [Document.from_token_counts(seed, tsvector(t)) for t in TOY_CORPUS]
    index = Bm25Index.build(
        docs, payloads=list(range(1, 11)), engine="blockmax", device="cpu"
    )
    q = Query.from_tokens(seed, tsvector("PostgreSQL").keys())
    assert [h.payload for h in index.search(q, k=10)] == [8, 9, 4, 1, 7, 2]
    assert [h.payload for h in index.search_batch([q], k=10)[0]] == [
        8, 9, 4, 1, 7, 2,
    ]


def test_stream_readme_toy_anchor():
    seed = random_seed()
    docs = [Document.from_token_counts(seed, tsvector(t)) for t in TOY_CORPUS]
    ref = RefIndex.build(docs, payloads=list(range(1, 11)), seed=seed)
    index = Bm25Index.build(docs, payloads=list(range(1, 11)), seed=seed, device="cpu")
    q = Query.from_tokens(seed, tsvector("PostgreSQL").keys())
    assert [h.payload for h in index.search(q, k=10)] == [8, 9, 4, 1, 7, 2]
    assert [h.payload for h in index.search_batch([q], k=10)[0]] == [
        8, 9, 4, 1, 7, 2,
    ]
    assert hits_of(index.search_batch([q], k=10)) == hits_of(ref.search_batch([q], k=10))


def test_stream_search_batch(stream_pair):
    ref, port, queries = stream_pair
    assert_batch_equal(ref, port, queries)
    assert_batch_equal(ref, port, queries, k=3)
    assert_batch_equal(ref, port, queries, k=100)
    assert port.engine().memory_report() == ref.engine().memory_report()


def test_stream_search_single(stream_pair):
    ref, port, queries = stream_pair
    for q in queries[:8]:
        assert hits_of([port.search(q, k=10)]) == hits_of([ref.search(q, k=10)])


def test_stream_bulkdelete(stream_pair):
    ref, port, queries = stream_pair

    def pred(p):
        return p % 7 == 0

    assert port.bulkdelete(pred) == ref.bulkdelete(pred) > 0
    got = assert_batch_equal(ref, port, queries)
    assert all(p % 7 for hits in got for _, p in hits)


def test_stream_prefilter(stream_pair):
    ref, port, queries = stream_pair
    sess = SessionConfig(prefilter=True)

    def keep(p):
        return p % 2 == 1

    got = assert_batch_equal(ref, port, queries, filter_fn=keep, session=sess)
    assert all(p % 2 for hits in got for _, p in hits)
    # Post-filter mode (prefilter off) goes through the same batch path.
    assert_batch_equal(ref, port, queries, filter_fn=keep)


def test_stream_growing_search_batch_and_maintain(stream_pair, rng):
    from vectorchord_bm25_tpu_torch.index.growing import GrowingSegment
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    ref, port, queries = stream_pair
    new = make_docs(rng, 60, vocab=VOCAB)
    for i, doc in enumerate(new[:40]):
        ref.insert(doc, 100_000 + i)
        port.insert(doc, 100_000 + i)
    got = assert_batch_equal(ref, port, queries)
    assert any(p >= 100_000 for hits in got for _, p in hits)
    assert isinstance(port.growing, GrowingSegment)
    assert isinstance(port.growing.device_engine(), StreamEngine)
    # Deletes in both segments refresh the growing engine's bitmap; a
    # prefilter reaches it too.
    assert port.bulkdelete(lambda p: p % 5 == 0) == ref.bulkdelete(lambda p: p % 5 == 0)
    assert_batch_equal(ref, port, queries)
    sess = SessionConfig(prefilter=True)
    assert_batch_equal(
        ref, port, queries, filter_fn=lambda p: p % 3 != 1, session=sess
    )
    # Docs inserted after the engine was built form the host-scored tail.
    for i, doc in enumerate(new[40:]):
        ref.insert(doc, 100_040 + i)
        port.insert(doc, 100_040 + i)
    assert_batch_equal(ref, port, queries)
    assert port.growing._dev_engine_n == 40 < len(port.growing)
    ref.maintain()
    port.maintain()
    assert isinstance(port.growing, GrowingSegment) and not len(port.growing)
    assert port.growing.device == port.device
    got = assert_batch_equal(ref, port, queries)
    assert any(p >= 100_000 for hits in got for _, p in hits)
    port.insert(new[0], 300_000)
    ref.insert(new[0], 300_000)
    assert_batch_equal(ref, port, queries)


def test_from_reference_stream_checkpoint(stream_pair, rng, tmp_path):
    ref, _, queries = stream_pair
    ref.bulkdelete(lambda p: p % 3 == 0)
    for i, doc in enumerate(make_docs(rng, 10, vocab=VOCAB)):
        ref.insert(doc, 200_000 + i)
    ref.bulkdelete(lambda p: p == 200_003)
    save_index(ref, str(tmp_path / "idx"))
    loaded = load_index(str(tmp_path / "idx"))
    port = Bm25Index.from_reference(loaded, device="cpu")
    assert port.engine_kind == "stream" and port.engine_options == ref.engine_options
    got = assert_batch_equal(ref, port, queries)
    assert any(p >= 200_000 for hits in got for _, p in hits)
    for q in queries[:6]:
        assert hits_of([port.search(q, k=10)]) == hits_of([ref.search(q, k=10)])


def test_from_reference_keeps_unported_engine(corpus):
    # Every engine of the reference is ported now: from_reference keeps the
    # reference's engine and its options, and serves them.
    docs, payloads, queries = corpus
    for engine, opts in (
        ("exact", {"strategy": "sparse", "impact_dtype": "bfloat16"}),
        ("exact", {"compact": True}),
        ("hybrid", {"use_pallas": "interpret", "heavy_mode": "pruned", "chunk": 4}),
    ):
        ref = RefIndex.build(docs[:300], engine=engine, engine_options=opts)
        port = Bm25Index.from_reference(ref, device="cpu")
        assert port.engine_kind == engine and port.engine_options == opts
        assert_batch_equal(ref, port, queries[:16])
        assert port.engine().memory_report() == ref.engine().memory_report()


def test_from_reference_serves_reference_engine_options(corpus):
    # A reference blockmax index built with use_pallas in its engine_options
    # crosses with no override and serves, equal to the reference bit for bit.
    docs, payloads, queries = corpus
    ref = RefIndex.build(
        docs[:300], engine="blockmax",
        engine_options={"use_pallas": "interpret", "chunk": 4},
    )
    port = Bm25Index.from_reference(ref, device="cpu")
    assert port.engine_options == {"use_pallas": "interpret", "chunk": 4}
    assert_batch_equal(ref, port, queries[:16])
    assert port.engine().chunk == 4


def test_from_reference_checkpoint(pair, rng, tmp_path):
    ref, _, queries = pair
    ref.bulkdelete(lambda p: p % 3 == 0)
    for i, doc in enumerate(make_docs(rng, 10, vocab=VOCAB)):
        ref.insert(doc, 200_000 + i)
    ref.bulkdelete(lambda p: p == 200_003)
    save_index(ref, str(tmp_path / "idx"))
    loaded = load_index(str(tmp_path / "idx"))
    # The checkpoint's meta.json carries the reference's engine_options,
    # use_pallas included: they serve with no override.
    port = Bm25Index.from_reference(loaded, device="cpu")
    assert port.engine_options == REF_OPTS
    for q in queries[:6]:
        assert hits_of([port.search(q, k=10)]) == hits_of([ref.search(q, k=10)])
    ref.maintain()
    port.maintain()
    assert_batch_equal(ref, port, queries)


@pytest.mark.parametrize("engine", ["exact", "hybrid"])
def test_unported_engines_raise(corpus, engine):
    # No engine is left unported: what used to raise NotImplementedError
    # serves, equal to the reference; only an unknown engine raises.
    docs, payloads, queries = corpus
    seed = random_seed()
    index = Bm25Index.build(docs[:300], seed=seed, engine=engine, device="cpu")
    ref = RefIndex.build(docs[:300], seed=seed, engine=engine)
    assert_batch_equal(ref, index, queries[:16], k=5)
    with pytest.raises(ValueError, match="unknown engine"):
        Bm25Index.build(docs[:50], engine=engine + "?", device="cpu")


def test_no_cpu_fallback(corpus, monkeypatch):
    # The facade defaults to the card; without one it raises rather than
    # serve on the CPU.
    docs, _, queries = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = Bm25Index.build(docs[:50], engine="blockmax")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index.search_batch(queries[:2], 5)
    index = Bm25Index.build(docs[:50])  # the default engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index.search_batch(queries[:2], 5)
    index.insert(docs[0], 99)  # the growing segment's engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index.growing.topk_batch_async(
            *batch_lookup(index.sealed.lookup_tokens, queries[:2]), 2, 5, None
        )
