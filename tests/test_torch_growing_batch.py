"""``tests/test_growing_batch.py`` replayed on the port's ``Bm25Index``
with ``device="cpu"``: batched serving with a populated growing segment.
The batched path scores the growing segment as one vectorized pass and
merges with the sealed results by lexsort; these tests pin (a) the merged
ranking against the single-query path and (b) that a 10k-doc growing
segment does not collapse batched throughput.  Imports are rewritten and
every assertion is the reference's (each test names its engine).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Query  # noqa: E402

from test_torch_maintain_scale import Bm25Index  # noqa: E402  (the port's, on the CPU)
from test_torch_mutation import make_docs  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _queries(rng, n, vocab):
    return [
        Query.from_int_ids(
            np.unique(rng.integers(0, vocab, size=3)).tolist()
        )
        for _ in range(n)
    ]


class TestGrowingBatchCorrectness:
    def test_batched_matches_single_query_path(self, rng):
        """The batched [Q, G] growing pass + lexsort merge must return
        exactly what the (already-pinned) single-query path returns —
        growing docs score with sealed-segment statistics, so the
        sequential `search` IS the oracle (search.rs:83-135 merges the
        same way)."""
        vocab = 60
        sealed_docs = make_docs(rng, 300, vocab=vocab)
        grow_docs = make_docs(rng, 80, vocab=vocab)
        idx = Bm25Index.build(sealed_docs, engine="exact")
        for j, d in enumerate(grow_docs):
            idx.insert(d, payload=1000 + j)

        queries = _queries(rng, 32, vocab)
        got = idx.search_batch(queries, k=10)
        for q, g_hits in zip(queries, got):
            w_hits = idx.search(q, k=10)
            assert [h.payload for h in g_hits] == [
                h.payload for h in w_hits
            ]
            np.testing.assert_allclose(
                [h.score for h in g_hits],
                [h.score for h in w_hits],
                rtol=1e-6,
            )
        # The growing segment must actually contribute hits.
        assert any(
            h.payload >= 1000 for row in got for h in row
        )

    def test_async_matches_sync(self, rng):
        """search_batch_async (the pipelined facade path) must return
        exactly search_batch's results — with growing docs, deletes,
        and a post-filter — and tolerate pipelined multi-batch dispatch
        with mutations between dispatch and finalize (results reflect
        dispatch-time state for the device inputs; this pins that the
        finalize is safe, not a point-in-time snapshot guarantee)."""
        vocab = 80
        idx = Bm25Index.build(make_docs(rng, 400, vocab=vocab), engine="stream")
        for j, d in enumerate(make_docs(rng, 60, vocab=vocab)):
            idx.insert(d, payload=2000 + j)
        idx.bulkdelete_payloads([2000 + j for j in range(10)])
        queries = _queries(rng, 24, vocab)

        sync = idx.search_batch(queries, k=8)
        fin = idx.search_batch_async(queries, k=8)
        assert [
            [(h.payload, round(h.score, 5)) for h in row] for row in fin()
        ] == [
            [(h.payload, round(h.score, 5)) for h in row] for row in sync
        ]

        # Post-filter mode (prefilter off by default) through the async
        # path.
        flt = lambda p: p % 2 == 0  # noqa: E731
        sync_f = idx.search_batch(queries, k=8, filter_fn=flt)
        fin_f = idx.search_batch_async(queries, k=8, filter_fn=flt)
        assert [[h.payload for h in row] for row in fin_f()] == [
            [h.payload for h in row] for row in sync_f
        ]

        # Pipelined dispatch: all batches in flight, then finalize; an
        # insert between dispatch and finalize must not corrupt results.
        batches = [queries[:12], queries[12:]]
        fins = [idx.search_batch_async(b, k=8) for b in batches]
        idx.insert(make_docs(rng, 1, vocab=vocab)[0], payload=9999)
        got = [row for fin in fins for row in fin()]
        again = idx.search_batch(queries, k=8)
        for row_a, row_b in zip(got, again):
            pa = [h.payload for h in row_a if h.payload != 9999]
            pb = [h.payload for h in row_b if h.payload != 9999]
            assert pa == pb

    def test_growing_only_index(self, rng):
        idx = Bm25Index.build(make_docs(rng, 5, vocab=20), engine="exact")
        for j, d in enumerate(make_docs(rng, 50, vocab=20)):
            idx.insert(d, payload=100 + j)
        hits = idx.search_batch(_queries(rng, 8, 20), k=60)
        assert any(h.payload >= 100 for row in hits for h in row)


class TestGrowingBatchThroughput:
    def test_growing_does_not_collapse_batch_qps(self, rng):
        """Batched search with 10k growing docs must stay within a small
        factor of sealed-only (the [Q, G] pass is one dispatch, not Q
        Python loops).  CPU timings are noisy, so the bound is loose;
        no device number is taken here."""
        vocab = 2000
        n_sealed, n_grow = 40_000, 10_000
        docs = make_docs(rng, n_sealed, vocab=vocab, max_len=30)
        idx = Bm25Index.build(docs, engine="exact")
        queries = _queries(rng, 256, vocab)

        idx.search_batch(queries, k=10)  # warmup
        t0 = time.perf_counter()
        idx.search_batch(queries, k=10)
        sealed_only = time.perf_counter() - t0

        for j, d in enumerate(make_docs(rng, n_grow, vocab=vocab, max_len=30)):
            idx.insert(d, payload=n_sealed + j)
        idx.search_batch(queries, k=10)  # warmup of the growing path
        t0 = time.perf_counter()
        hits = idx.search_batch(queries, k=10)
        with_growing = time.perf_counter() - t0

        assert any(h.payload >= n_sealed for row in hits for h in row)
        # A per-query Python re-concatenation regression is >50x here;
        # the vectorized pass stays within a small constant.
        assert with_growing < 5 * sealed_only + 0.25, (
            with_growing,
            sealed_only,
        )

    def test_interleaved_insert_batch_serving(self, rng):
        """Inserts landing BETWEEN served batches put the growing
        segment's lazy O(G log G) device-engine rebuild on the serving
        path every batch (index/growing.py device_engine).  The
        interleaved workload must stay within a small constant of
        steady-state growing serving — a rebuild-per-QUERY (or
        rebuild-from-scratch-per-insert) regression is 10-50x here.
        CPU timings are noisy so the bound is loose."""
        vocab = 2000
        n_sealed, n_grow = 20_000, 10_000
        docs = make_docs(rng, n_sealed, vocab=vocab, max_len=30)
        idx = Bm25Index.build(docs, engine="stream")
        extra = make_docs(rng, n_grow + 256, vocab=vocab, max_len=30)
        for j, d in enumerate(extra[:n_grow]):
            idx.insert(d, payload=n_sealed + j)
        queries = _queries(rng, 256, vocab)
        batches = [queries[i : i + 32] for i in range(0, 256, 32)]

        idx.search_batch(queries[:32], k=10)  # warmup
        steady = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            for b in batches:
                idx.search_batch(b, k=10)
            steady = min(steady, time.perf_counter() - t0)

        burst = iter(extra[n_grow:])
        t0 = time.perf_counter()
        for bi, b in enumerate(batches):
            for j in range(16):  # 16-doc insert burst between batches
                idx.insert(next(burst), payload=100_000 + bi * 16 + j)
            idx.search_batch(b, k=10)
        interleaved = time.perf_counter() - t0

        assert interleaved < 4 * steady + 0.5, (interleaved, steady)
        # The interleaved inserts are served (no stale device engine):
        # querying an inserted doc's own terms must return it.
        last = extra[n_grow]  # payload 100_000 (first burst doc)
        hits = idx.search_batch(
            [Query(keys=last.keys[: min(4, last.keys.size)])], k=50
        )
        assert any(h.payload == 100_000 for h in hits[0])
