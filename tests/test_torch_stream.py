"""Port's StreamEngine (dense strategy) vs the reference's, on the CPU.

The reference runs its jnp kernels on the CPU, as tests/test_stream.py
runs them; the port runs the plain versions of its kernels, which a CPU
tensor dispatches to.  Both add every (query, doc)'s terms in the same
order with the same f32 expression, so scores are bit-equal and ids and
payloads equal.  Replays tests/test_stream.py's engine cases.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.index.stream import build_stream_index  # noqa: E402
from vectorchord_bm25_tpu.search.exact import oracle_topk  # noqa: E402
from vectorchord_bm25_tpu.search.stream import (  # noqa: E402
    StreamEngine as RefEngine,
)
from vectorchord_bm25_tpu.text.intern import Query  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk  # noqa: E402
from vectorchord_bm25_tpu_torch.search import stream as port_stream  # noqa: E402
from vectorchord_bm25_tpu_torch.search.stream import (  # noqa: E402
    StreamEngine,
    window_ordinals,
)
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402

from test_sealed import make_docs  # noqa: E402
from test_stream import random_segment  # noqa: E402
from test_torch_stream_kernel import big_gap_segment  # noqa: E402


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


torch.set_num_threads(2)


def engines(seg, **kw):
    si = kw.pop("stream", None) or build_stream_index(seg)
    ref = RefEngine(seg, stream=si, strategy="dense", **kw)
    port = StreamEngine(seg, stream=si, strategy="dense", device="cpu", **kw)
    return ref, port


def assert_same(ref, port, queries, k, **kw):
    s1, i1, p1 = ref.search(queries, k, **kw)
    s2, i2, p2 = port.search(queries, k, **kw)
    np.testing.assert_array_equal(i2, i1)
    assert np.array_equal(s2, s1)
    np.testing.assert_array_equal(p2, p1)
    return s2, i2


def rand_queries(rng, n, vocab, terms=4):
    return [
        Query.from_int_ids(rng.integers(0, vocab, size=terms).tolist())
        for _ in range(n)
    ]


@pytest.mark.parametrize("k", [1, 10, 100])
def test_vs_oracle(rng, k):
    seg = random_segment(rng, 3000, 80, 30000, tf_hi=5)
    ref, port = engines(seg)
    queries = rand_queries(rng, 32, 90)
    _, ids = assert_same(ref, port, queries, k)
    for qi, q in enumerate(queries):
        _, e_ids = oracle_topk(seg, q, k, dtype=np.float32)
        assert np.array_equal(ids[qi][ids[qi] >= 0], e_ids), qi


def test_vs_exact_engine(rng):
    seg = build_sealed_segment(make_docs(rng, 400, vocab=50))
    ref, port = engines(seg)
    _, ids = assert_same(ref, port, rand_queries(rng, 16, 55, terms=3), 10)
    assert (ids >= 0).any()


def test_big_gaps_and_tf16(rng):
    seg = big_gap_segment(rng)
    si = build_stream_index(seg)
    assert si.tf_width == 2
    ref, port = engines(seg, stream=si)
    queries = [Query.from_int_ids([0, 1, 2]), Query.from_int_ids([0]), Query.from_int_ids([2, 1])]
    _, ids = assert_same(ref, port, queries, 10)
    _, e_ids = oracle_topk(seg, queries[0], 10, dtype=np.float32)
    assert np.array_equal(ids[0][ids[0] >= 0], e_ids)


def test_deletes_and_filter(rng):
    seg = random_segment(rng, 1000, 40, 8000)
    ref, port = engines(seg)
    deleted = rng.random(1000) < 0.3
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    fmask = rng.random(1000) < 0.5
    queries = rand_queries(rng, 8, 45)
    _, ids = assert_same(ref, port, queries, 10, filter_mask=fmask)
    live = ids[ids >= 0]
    assert live.size and not deleted[live].any() and fmask[live].all()
    # Fractional filter values: > 0 keeps (search/stream.py:527-539).
    weights = np.where(fmask, 0.25, 0.0).astype(np.float32)
    assert_same(ref, port, queries, 10, filter_mask=weights)
    # Un-deleting restores.
    ref.set_deleted(np.zeros(1000, dtype=bool))
    port.set_deleted(np.zeros(1000, dtype=bool))
    assert_same(ref, port, queries, 10)


def test_oov_and_empty_queries(rng):
    seg = random_segment(rng, 200, 20, 1000)
    ref, port = engines(seg)
    queries = [
        Query.from_int_ids([99999]),
        Query(keys=np.zeros(0, dtype="S16")),
        Query.from_int_ids([0, 1]),
    ]
    _, ids = assert_same(ref, port, queries, 5)
    assert np.all(ids[0] == -1) and np.all(ids[1] == -1)
    assert_same(ref, port, queries[:2], 5)  # a batch with no window at all
    with pytest.raises(ValueError):
        port.search(queries, 0)


def test_adjacent_terms_and_k_above_n_docs(rng):
    seg = random_segment(rng, 300, 12, 2000, tf_hi=4)
    ref, port = engines(seg)
    queries = [
        Query.from_int_ids([3, 4]),
        Query.from_int_ids([3, 4, 5, 6]),
        Query.from_int_ids([5, 9, 7]),
    ]
    assert_same(ref, port, queries, 10)
    assert_same(ref, port, queries, 1000)


def test_multiple_dispatches(rng, monkeypatch):
    # A small accumulator budget and many windows split the batch into the
    # reference's dispatches; the port must cut it the same way.
    seg = random_segment(rng, 3000, 60, 40000, tf_hi=3)
    budget = 4 * 3001 * 5  # q_cap = 5 queries a dispatch
    ref, port = engines(seg, accumulator_budget=budget)
    queries = rand_queries(rng, 23, 60)
    calls = []
    real = port_stream.stream_dense_accumulate

    def record(*args):
        calls.append(args[-2])
        return real(*args)

    monkeypatch.setattr(port_stream, "stream_dense_accumulate", record)
    assert_same(ref, port, queries, 10)
    assert calls == [8, 8, 8, 8, 8]  # ceil(23 / 5) dispatches, rows bucketed


def test_lockstep_dispatch_inputs(rng):
    # The same dispatch (wsrc, wq) through both engines' device functions.
    from vectorchord_bm25_tpu.search.stream import _stream_dense

    import jax.numpy as jnp

    seg = random_segment(rng, 2000, 50, 20000, tf_hi=20)
    ref, port = engines(seg)
    queries = rand_queries(rng, 12, 55) + [Query.from_int_ids([7, 7])]
    (rows, wsrc, q_start, w_ord, n_qb), = list(port._dispatches(port._layout(*looked_up(port, queries))[0]))
    assert rows.size == len(queries) and wsrc.size % 128 == 0
    # The reference's per-window query rows (its pad windows add to row 0).
    wq = np.zeros(wsrc.size, dtype=np.int32)
    wq[: q_start[-1]] = np.repeat(np.arange(n_qb, dtype=np.int32), np.diff(q_start))
    assert (w_ord[q_start[-1] :] == -1).all() and (wsrc[q_start[-1] :] == port._pad_win).all()
    n = seg.n_docs
    r_s, r_i = _stream_dense(
        ref.dev_words, ref.dev_s1bd, ref.dev_w_off, ref.dev_w_base,
        ref.dev_w_meta, ref.dev_w_s0, jnp.asarray(wsrc), jnp.asarray(wq),
        k=16, n_docs=n, n_q=n_qb,
    )
    acc = stream_kernel.stream_dense_accumulate(
        port.dev_words, port.dev_s1bd, port.dev_w_off, port.dev_w_base,
        port.dev_w_meta, port.dev_w_s0,
        *(torch.from_numpy(x) for x in (wsrc, q_start, w_ord)), n_qb, n,
    )
    s, i = topk.dense_topk(acc, 16, n)
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    assert np.array_equal(s.numpy(), r_s)
    live = np.isfinite(r_s)
    assert live.any()
    np.testing.assert_array_equal(i.numpy()[live], r_i[live])


def test_window_ordinals(rng):
    # Adjacent token ids, whose window spans touch, still get one ordinal
    # each.
    seg = random_segment(rng, 500, 6, 2000)
    si = build_stream_index(seg)
    port = StreamEngine(seg, stream=si, device="cpu")
    queries = [Query.from_int_ids([1, 2]), Query.from_int_ids([3, 5]), Query.from_int_ids([4])]
    (wsrc, starts, sizes), _, _ = port._layout(*looked_up(port, queries))
    ords = window_ordinals(si, wsrc, starts, sizes)
    tws = si.token_w_start
    want = np.concatenate(
        [np.zeros(tws[2] - tws[1]), np.ones(tws[3] - tws[2]),
         np.zeros(tws[4] - tws[3]), np.ones(tws[6] - tws[5]),
         np.zeros(tws[5] - tws[4])]
    )
    np.testing.assert_array_equal(ords, want)


def test_memory_report_equals_reference(rng):
    seg = random_segment(rng, 3000, 80, 30000, tf_hi=400)
    ref, port = engines(seg)
    rep = port.memory_report()
    assert rep == ref.memory_report()
    si = port.stream
    # Stream words, the s1_eff table and 14 B of metadata per window.
    assert rep["total"] == si.words.nbytes + 4 * (si.n_docs + 1) + 14 * (si.n_windows + 1)


@pytest.mark.parametrize("strategy", ["sparse", "maxscore"])
def test_unported_strategies_raise(rng, strategy):
    # The strategies the dense slice left out now serve, as the reference.
    seg = random_segment(rng, 200, 20, 1000)
    si = build_stream_index(seg)
    ref = RefEngine(seg, stream=si, strategy=strategy)
    port = StreamEngine(seg, stream=si, strategy=strategy, device="cpu")
    queries = rand_queries(rng, 6, 20)
    s1, i1, p1 = ref.search(queries, 5)
    s2, i2, p2 = port.search(queries, 5)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_allclose(s2, s1, rtol=2e-6)
    assert port.last_ms_stats == ref.last_ms_stats
    assert (ref.last_ms_stats is not None) == (strategy == "maxscore")


def test_auto_at_scale_raises(rng, monkeypatch):
    # 'auto' at SPARSE_MIN_DOCS and above routes per query to MaxScore or
    # the sparse reduction, as the reference does.
    seg = random_segment(rng, 200, 20, 1000)
    si = build_stream_index(seg)
    auto = StreamEngine(seg, stream=si, device="cpu")
    queries = rand_queries(rng, 4, 20)
    ref = RefEngine(seg, stream=si)
    s1, i1, _ = ref.search(queries, 5)
    s2, i2, _ = auto.search(queries, 5)  # auto below 2^21 docs: dense
    assert np.array_equal(s1, s2) and np.array_equal(i1, i2)
    assert auto.last_ms_stats is None
    for cls in (RefEngine, StreamEngine):  # the port keeps its own copy
        monkeypatch.setattr(cls, "SPARSE_MIN_DOCS", 100)
    s1, i1, _ = ref.search(queries, 5)
    s2, i2, _ = auto.search(queries, 5)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(s2, s1, rtol=2e-6)
    assert auto.last_ms_stats == ref.last_ms_stats
    assert auto.last_ms_stats["batch_queries"] == len(queries)


def test_no_cpu_fallback(rng, monkeypatch):
    seg = random_segment(rng, 200, 20, 1000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEngine(seg)
