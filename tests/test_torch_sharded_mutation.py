"""The port's ``ShardedIndex`` mutable surface and persistence on the CPU:
``tests/test_sharded_mutation.py`` and ``tests/test_sharded_concurrent.py``
replayed with ``device="cpu"``.

- The port's single ``Bm25Index`` (exact engine) is the oracle, as the
  reference's single index is in the replayed tests: the same hits, ranks
  equal up to swaps of tied scores, scores within rtol 2e-5.
- A lockstep fuzz drives the reference's ``ShardedIndex`` (8-device CPU
  mesh) and the port's with one stream of inserts, deletes, maintains and
  searches: every result equal bit for bit.
- Checkpoints and WALs cross between the packages both ways: a sharded
  index saved (with a non-empty WAL) by one package opens in the other and
  serves the same bits.

Tolerance: none, except against the single index (rtol 2e-5, the
reference's rule).
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index import storage as ref_storage  # noqa: E402
from vectorchord_bm25_tpu.parallel.shard import ShardedIndex as RefShardedIndex  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Query as RefQuery  # noqa: E402
from vectorchord_bm25_tpu_torch import (  # noqa: E402
    Bm25Index,
    Document,
    Query,
    SearchOptions,
    SessionConfig,
    ShardedIndex,
    load_sharded_index,
    open_sharded_index,
    save_sharded_index,
)
from vectorchord_bm25_tpu_torch.utils.rwlock import RWLock  # noqa: E402

from test_exact import rank_match  # noqa: E402
from test_fuzz import Oracle, edit_distance, random_doc  # noqa: E402
from test_sealed import make_docs as make_ref_docs  # noqa: E402

torch.set_num_threads(2)


def make_docs(rng, n, vocab):
    return [Document(keys=d.keys, values=d.values) for d in make_ref_docs(rng, n, vocab=vocab)]


def build(docs, **kw):
    return ShardedIndex.build(docs, 8, device="cpu", **kw)


def oracle_of(docs, **kw):
    return Bm25Index.build(docs, engine="exact", device="cpu", **kw)


@pytest.fixture(scope="module")
def mesh8():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("d",))


def _assert_matches_oracle(sharded, oracle, queries, k, filter_fn=None):
    scores, _, payloads = sharded.search(queries, k, filter_fn=filter_fn)
    for qi, query in enumerate(queries):
        hits = oracle.search(query, k=k, filter_fn=filter_fn)
        o_pay, o_scores = [h.payload for h in hits], [h.score for h in hits]
        got = [int(p) for p in payloads[qi] if p >= 0]
        assert len(got) == len(o_pay), (qi, got, o_pay)
        rank_match(
            np.asarray(got), np.asarray(o_pay), scores[qi][: len(got)],
            np.asarray(o_scores, dtype=np.float32),
        )
        np.testing.assert_allclose(scores[qi][: len(got)], o_scores, rtol=2e-5)


def test_insert_visible_and_scored_globally(rng):
    docs = make_docs(rng, 100, vocab=12)
    sharded, oracle = build(docs), oracle_of(docs)
    new_doc = Document.from_int_ids([0, 1, 1, 2])
    sharded.insert(new_doc, payload=555)
    oracle.insert(new_doc, payload=555)
    _assert_matches_oracle(sharded, oracle, [Query.from_int_ids([0, 1]), Query.from_int_ids([2])], 20)
    assert sharded.n_live == 101


def test_bulkdelete_predicate(rng):
    docs = make_docs(rng, 120, vocab=10)
    sharded, oracle = build(docs), oracle_of(docs)
    n1 = sharded.bulkdelete(lambda p: p % 3 == 0)
    n2 = oracle.bulkdelete(lambda p: p % 3 == 0)
    assert n1 == n2 > 0
    assert sharded.bulkdelete(lambda p: p % 3 == 0) == 0  # idempotent
    queries = [Query.from_int_ids(rng.integers(0, 10, size=3).tolist()) for _ in range(3)]
    _assert_matches_oracle(sharded, oracle, queries, 15)


def test_bulkdelete_payloads(rng):
    sharded = build(make_docs(rng, 60, vocab=8))
    assert sharded.bulkdelete_payloads([5, 7, 11]) == 3
    _, _, payloads = sharded.search([Query.from_int_ids([0, 1, 2])], 60)
    assert not ({5, 7, 11} & set(int(p) for p in payloads[0] if p >= 0))


@pytest.mark.parametrize("engine", ["blockmax", "stream"])
def test_maintain_relabels_and_preserves_results(rng, engine):
    docs = make_docs(rng, 90, vocab=10)
    sharded, oracle = build(docs, engine=engine), oracle_of(docs)
    sharded.bulkdelete(lambda p: p % 4 == 1)
    oracle.bulkdelete(lambda p: p % 4 == 1)
    for j in range(5):
        d = Document.from_int_ids(rng.integers(0, 10, size=6).tolist())
        sharded.insert(d, payload=1000 + j)
        oracle.insert(d, payload=1000 + j)
    sharded.maintain()
    oracle.maintain()
    assert len(sharded.growing) == 0 and not sharded.deleted.any()
    assert sharded.n_docs == oracle.sealed.n_docs
    queries = [Query.from_int_ids(rng.integers(0, 10, size=3).tolist()) for _ in range(4)]
    _assert_matches_oracle(sharded, oracle, queries, 20)


def test_prefilter_vs_postfilter(rng):
    docs = make_docs(rng, 80, vocab=6)
    sharded = build(docs)
    oracle = oracle_of(docs, search_options=SearchOptions(prefilter=True))
    sharded.search_options = SearchOptions(prefilter=True)
    flt = lambda p: p % 2 == 0  # noqa: E731
    queries = [Query.from_int_ids([0, 1])]
    _assert_matches_oracle(sharded, oracle, queries, 10, filter_fn=flt)
    sess = SessionConfig(prefilter=False)
    _, _, payloads = sharded.search(queries, 10, filter_fn=flt, session=sess)
    got = [int(p) for p in payloads[0] if p >= 0]
    assert all(p % 2 == 0 for p in got)
    assert got == [h.payload for h in oracle.search(queries[0], k=10, filter_fn=flt, session=sess)]


def test_brute_force_paths(rng):
    docs = make_docs(rng, 50, vocab=5)
    sharded, oracle = build(docs), oracle_of(docs)
    q = Query.from_int_ids([0, 1])
    _, _, payloads = sharded.search([q], -1)
    got = [int(p) for p in payloads[0] if p >= 0]
    assert got == [h.payload for h in oracle.search(q, k=-1)]
    _, _, p2 = sharded.search([q], 7, session=SessionConfig(enable_scan=False))
    assert [int(x) for x in p2[0] if x >= 0] == got[:7]
    with pytest.raises(ValueError, match="needed rows"):
        sharded.search([q], 0)


def test_hybrid_engine_matches_exact(rng):
    docs = make_docs(rng, 300, vocab=25)
    exact, hybrid = build(docs, engine="exact"), build(docs, engine="hybrid")
    queries = [Query.from_int_ids(rng.integers(0, 25, size=3).tolist()) for _ in range(6)]
    s1, i1, _ = exact.search(queries, 10)
    s2, i2, _ = hybrid.search(queries, 10)
    for qi in range(len(queries)):
        g1, g2 = i1[qi][i1[qi] >= 0], i2[qi][i2[qi] >= 0]
        assert len(g1) == len(g2), qi
        rank_match(g2, g1, s2[qi][: len(g2)], s1[qi][: len(g1)])


def test_evaluate_matches_single_chip(rng):
    docs = make_docs(rng, 70, vocab=9)
    sharded, oracle = build(docs), oracle_of(docs)
    d, q = docs[3], Query.from_int_ids([0, 1, 2])
    np.testing.assert_allclose(sharded.evaluate(d, q), oracle.evaluate(d, q), rtol=1e-12)
    assert sharded.operator_score(d, q) == -sharded.evaluate(d, q)


def test_save_load_roundtrip(rng, tmp_path):
    sharded = build(make_docs(rng, 100, vocab=10), engine="blockmax")
    sharded.bulkdelete(lambda p: p % 5 == 0)
    sharded.insert(Document.from_int_ids([1, 2, 3]), payload=777)
    save_sharded_index(sharded, str(tmp_path / "idx"))
    loaded = load_sharded_index(str(tmp_path / "idx"), device="cpu")
    assert loaded.engine == "blockmax" and loaded.seed == sharded.seed
    assert loaded.n_docs == sharded.n_docs and loaded.device.type == "cpu"
    assert np.array_equal(loaded.deleted, sharded.deleted)
    assert len(loaded.growing) == 1
    queries = [Query.from_int_ids(rng.integers(0, 10, size=3).tolist()) for _ in range(3)]
    for a, b in zip(sharded.search(queries, 10), loaded.search(queries, 10)):
        np.testing.assert_array_equal(a, b)


def test_save_load_preserves_memory_modes(rng, tmp_path):
    sharded = build(make_docs(rng, 80, vocab=10), engine="blockmax", posting_mode="tf")
    d = str(tmp_path / "idx")
    save_sharded_index(sharded, d)
    loaded = load_sharded_index(d, device="cpu")
    assert loaded.posting_mode == "tf" and loaded.memory_mode == sharded.memory_mode
    assert loaded.memory_report() == sharded.memory_report()
    q = [Query.from_int_ids([0, 1, 2])]
    np.testing.assert_array_equal(sharded.search(q, 10)[1], loaded.search(q, 10)[1])
    with pytest.raises(ValueError, match="not a sharded"):
        from vectorchord_bm25_tpu_torch import save_index

        save_index(oracle_of(make_docs(rng, 10, vocab=4)), str(tmp_path / "single"))
        load_sharded_index(str(tmp_path / "single"), device="cpu")


def test_wal_recovers_acknowledged_mutations(rng, tmp_path):
    d = str(tmp_path / "idx")
    save_sharded_index(build(make_docs(rng, 60, vocab=8)), d)
    live = open_sharded_index(d, device="cpu")
    live.insert(Document.from_int_ids([0, 1, 2]), payload=900)
    live.bulkdelete_payloads([3, 4])
    live.maintain()
    live.insert(Document.from_int_ids([1, 1]), payload=901)
    q = Query.from_int_ids([0, 1])
    s1, _, p1 = live.search([q], 60)
    recovered = open_sharded_index(d, device="cpu")  # "crash": no checkpoint
    assert recovered.n_live == live.n_live
    s2, _, p2 = recovered.search([q], 60)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(s1, s2)
    save_sharded_index(recovered, d)
    assert os.path.getsize(os.path.join(d, "wal.log")) == 0
    assert open_sharded_index(d, device="cpu").n_live == live.n_live


def _mutate(ix, doc):
    """One mutation stream, applied to either package's index (``doc``:
    that package's Document class): deletes, a maintain, then inserts and
    deletes after it (left in the WAL and the growing segment)."""
    ix.bulkdelete_payloads([3, 4, 17])
    ix.insert(doc.from_int_ids([0, 1, 2]), payload=900)
    ix.maintain()
    ix.insert(doc.from_int_ids([1, 1, 5]), payload=901)
    ix.insert(doc.from_int_ids([2, 7]), payload=902)
    ix.bulkdelete_payloads([902, 8])


@pytest.mark.parametrize("engine,opts", [("stream", {}), ("blockmax", {"posting_mode": "tf"}), ("hybrid", {})])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_and_wal_cross_packages(mesh8, tmp_path, engine, opts, writer):
    from vectorchord_bm25_tpu.text.intern import Document as RefDocument

    gen = np.random.default_rng(21)
    ref_docs = make_ref_docs(gen, 120, vocab=12)
    d = str(tmp_path / "idx")
    if writer == "reference":
        src = RefShardedIndex.build(ref_docs, 8, mesh=mesh8, engine=engine, **opts)
        ref_storage.save_sharded_index(src, d)
        src = ref_storage.open_sharded_index(d, mesh=mesh8)
        _mutate(src, RefDocument)
        dst = open_sharded_index(d, device="cpu")
    else:
        pdocs = [Document(keys=x.keys, values=x.values) for x in ref_docs]
        src = ShardedIndex.build(pdocs, 8, device="cpu", engine=engine, **opts)
        save_sharded_index(src, d)
        src = open_sharded_index(d, device="cpu")
        _mutate(src, Document)
        dst = ref_storage.open_sharded_index(d, mesh=mesh8)
    assert os.path.getsize(os.path.join(d, "wal.log")) > 0
    assert dst.n_live == src.n_live and dst.engine == engine and dst.axis == "d"
    assert np.array_equal(dst.deleted, src.deleted)
    ids = [gen.integers(0, 12, size=3).tolist() for _ in range(6)] + [[0, 1, 2], [7]]
    want = src.search([(Query if writer == "port" else RefQuery).from_int_ids(q) for q in ids], 15)
    got = dst.search([(RefQuery if writer == "port" else Query).from_int_ids(q) for q in ids], 15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["exact", "hybrid", "stream"])
def test_mutation_fuzz_lockstep_with_reference(mesh8, engine):
    """Randomized insert/search/delete/maintain loop driving the port and
    the reference with one operation stream; every search equal bit for
    bit, and the single index agrees by the reference's rule."""
    from vectorchord_bm25_tpu.text.intern import Document as RefDocument

    rng = np.random.default_rng({"exact": 1, "hybrid": 2, "stream": 3}[engine])
    ref_docs = make_ref_docs(rng, 64, vocab=8)
    pdocs = [Document(keys=x.keys, values=x.values) for x in ref_docs]
    ref = RefShardedIndex.build(ref_docs, 8, mesh=mesh8, engine=engine)
    port = build(pdocs, engine=engine)
    oracle = oracle_of(pdocs)
    next_payload = 1000
    for step in range(24):
        op = rng.choice(["insert", "insert", "search", "search", "search", "delete", "delete", "maintain"])
        if op == "insert":
            ids = rng.integers(0, 8, size=int(rng.integers(1, 6))).tolist()
            ref.insert(RefDocument.from_int_ids(ids), payload=next_payload)
            port.insert(Document.from_int_ids(ids), payload=next_payload)
            oracle.insert(Document.from_int_ids(ids), payload=next_payload)
            next_payload += 1
        elif op == "delete":
            target = int(rng.integers(0, next_payload))
            n = port.bulkdelete_payloads([target])
            assert n == ref.bulkdelete_payloads([target]) == oracle.bulkdelete_payloads([target])
        elif op == "maintain":
            for ix in (ref, port, oracle):
                ix.maintain()
        else:
            ids = rng.integers(0, 8, size=2).tolist()
            k = int(rng.integers(1, 30))
            want = ref.search([RefQuery.from_int_ids(ids)], k)
            got = port.search([Query.from_int_ids(ids)], k)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{engine} step {step}")
            _assert_matches_oracle(port, oracle, [Query.from_int_ids(ids)], k)
    assert port.n_live == ref.n_live == oracle.n_docs


def test_sharded_concurrent_fuzz():
    """Threads doing insert/select/delete with periodic maintain, selects
    checked against the brute-force oracle under the reference harness's
    lock discipline (tests/test_sharded_concurrent.py)."""
    vocab, n_initial, k = 30, 64, 12
    rng0 = np.random.default_rng(77)
    to_port = lambda d: Document(keys=d.keys, values=d.values)  # noqa: E731
    docs = [random_doc(rng0, vocab) for _ in range(n_initial)]
    index = build([to_port(d) for d in docs], engine="hybrid")
    oracle = Oracle()
    for p, d in enumerate(docs):
        oracle.insert(p, d)
    harness_lock = RWLock()
    payload_counter = [n_initial]
    counter_lock = threading.Lock()
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(12):
            op = rng.choice(["insert", "select", "select", "delete"])
            try:
                if op == "insert":
                    with harness_lock.read():
                        with counter_lock:
                            payload = payload_counter[0]
                            payload_counter[0] += 1
                        d = random_doc(rng, vocab)
                        index.insert(to_port(d), payload)
                        oracle.insert(payload, d)
                elif op == "delete":
                    with harness_lock.read():
                        with counter_lock:
                            target = int(rng.integers(0, payload_counter[0]))
                        index.bulkdelete_payloads([target])
                        oracle.delete(lambda p: p == target)
                else:
                    with harness_lock.write():
                        q = Query.from_int_ids(np.unique(rng.integers(0, vocab, size=3)).tolist())
                        _, _, payloads = index.search([q], k)
                        got_p = [int(p) for p in payloads[0] if p >= 0]
                        exp_p = [p for _, p in oracle.topk(index, q, k)]
                        if edit_distance(got_p, exp_p) > 2:
                            errors.append(f"got {got_p} expect {exp_p}")
            except Exception as e:  # pragma: no cover
                errors.append(f"{op}: {type(e).__name__}: {e}")

    def vacuumer():
        for _ in range(2):
            with harness_lock.write():
                index.maintain()

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(3)]
    threads.append(threading.Thread(target=vacuumer))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    index.maintain()
    q = Query.from_int_ids(list(range(5)))
    _, _, payloads = index.search([q], 30)
    got = [int(p) for p in payloads[0] if p >= 0]
    assert edit_distance(got, [p for _, p in oracle.topk(index, q, 30)]) <= 2
    assert index.n_live == len(oracle.docs)
