"""The port's ``ShardedIndex`` (``parallel/shard.py``, ``parallel/devbuild.py``)
on the CPU, against the reference's ``ShardedIndex`` on the 8-device CPU
mesh and against a single index: ``tests/test_sharded.py`` replayed with
``device="cpu"``.

- Every engine and mode (stream dense and MaxScore, exact, hybrid fast and
  compact, Block-Max impact and tf) equals the reference on the same
  documents: ids, payloads and scores bit for bit, with deletes, a
  prefilter and a k past the shard size.  Block-Max is the one body whose
  order of adds could differ (the reference's sharded body adds through a
  jnp scatter, the port's round through P1's arithmetic); on these inputs
  it too holds bit for bit, so the test asks for that.
- Against a single index on the same corpus the reference's own rule
  holds: the same hit counts, ranks equal up to swaps of tied scores,
  scores within rtol 2e-5 (``tests/test_sharded.py:43-50``).
- The host build equals the device build (every segment array), both
  equal the reference's, ``memory_report()`` equals the reference's, and
  ``from_reference`` carries state across.

The 1M-doc build and the 524k-doc certification-rate test of
``tests/test_sharded.py`` are not replayed here: they are too large for the
CPU run; ``chip_smoke.py`` phases (v) and (w) build and serve 2,097,152
docs in 8 shards on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.parallel.shard import ShardedIndex as RefShardedIndex  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Query as RefQuery  # noqa: E402
from vectorchord_bm25_tpu_torch import (  # noqa: E402
    Document,
    ExactEngine,
    Query,
    ShardedIndex,
    build_sealed_segment,
)

from test_exact import rank_match  # noqa: E402
from test_sealed import make_docs as make_ref_docs  # noqa: E402

torch.set_num_threads(2)

SEGMENT_FIELDS = (
    "doc_fieldnorm", "doc_payload", "token_keys", "token_df", "token_wand_fn",
    "token_wand_tf", "token_block_start", "block_min_doc", "block_max_doc",
    "block_n", "block_wand_fn", "block_wand_tf", "block_docids", "block_tfs",
)

MODES = [
    ("stream", {}),
    ("stream", {"strategy": "maxscore"}),
    ("exact", {}),
    ("hybrid", {}),
    ("hybrid", {"memory_mode": "compact"}),
    ("blockmax", {}),
    ("blockmax", {"posting_mode": "tf"}),
]


def port_docs(docs):
    return [Document(keys=d.keys, values=d.values) for d in docs]


def assert_segments_equal(a, b):
    assert a.n_docs == b.n_docs and a.sum_dl == b.sum_dl
    for f in SEGMENT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def assert_single_rule(s_scores, s_ids, e_scores, e_ids):
    """The reference's sharded-vs-single rule (tests/test_sharded.py:43-50)."""
    for qi in range(s_ids.shape[0]):
        got = s_ids[qi][s_ids[qi] >= 0]
        expect = e_ids[qi][e_ids[qi] >= 0]
        assert len(got) == len(expect), qi
        rank_match(got, expect, s_scores[qi][: len(got)], e_scores[qi][: len(expect)])
        np.testing.assert_allclose(
            s_scores[qi][: len(got)], e_scores[qi][: len(expect)], rtol=2e-5
        )


@pytest.fixture(scope="module")
def mesh8():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("d",))


@pytest.fixture(scope="module")
def corpus():
    gen = np.random.default_rng(0xC0)
    docs = make_ref_docs(gen, 500, vocab=50)
    ids = [gen.integers(0, 50, size=int(n)).tolist() for n in gen.integers(1, 6, size=14)]
    ids += [[], [12345], [0, 0, 3]]  # empty, absent, repeated term
    deleted = gen.random(500) < 0.15
    keep = gen.random(500) < 0.6
    return docs, ids, deleted, keep


def built_pair(mesh8, docs, engine, opts, **kw):
    build = {k: v for k, v in opts.items() if k != "memory_mode"}
    ref = RefShardedIndex.build(docs, 8, mesh=mesh8, engine=engine, **build, **kw)
    port = ShardedIndex.build(port_docs(docs), 8, device="cpu", engine=engine, **build, **kw)
    if "memory_mode" in opts:
        ref = RefShardedIndex(
            [v.segment for v in ref.views], ref.options, mesh=mesh8,
            engine=engine, memory_mode=opts["memory_mode"], seed=ref.seed,
        )
        port = ShardedIndex(
            [v.segment for v in port.views], port.options, device="cpu",
            engine=engine, memory_mode=opts["memory_mode"], seed=port.seed,
        )
    return ref, port


@pytest.mark.parametrize("engine,opts", MODES, ids=lambda x: str(x))
def test_engine_equals_reference(mesh8, corpus, engine, opts):
    docs, ids, deleted, keep = corpus
    ref, port = built_pair(mesh8, docs, engine, opts, payloads=np.arange(500) * 3)
    rq = [RefQuery.from_int_ids(q) for q in ids]
    pq = [Query.from_int_ids(q) for q in ids]
    for ix in (ref, port):
        ix.set_deleted(deleted)
    fil = lambda p: keep[p // 3]  # noqa: E731
    for k, flt in ((10, None), (3, fil), (90, None)):
        want = ref.search(rq, k, filter_fn=flt)
        got = port.search(pq, k, filter_fn=flt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert port.memory_report() == ref.memory_report()
    assert port.global_stats_step() == ref.global_stats_step()


@pytest.mark.parametrize("engine", ["stream", "exact", "blockmax"])
def test_matches_single_segment(corpus, engine):
    docs, ids, _, _ = corpus
    pdocs = port_docs(docs)
    single = ExactEngine(build_sealed_segment(pdocs), device="cpu")
    sharded = ShardedIndex.build(pdocs, 8, device="cpu", engine=engine)
    assert sharded.n_docs == 500 and sharded.sum_dl == single.segment.sum_dl
    queries = [Query.from_int_ids(q) for q in ids]
    s_scores, s_ids, _ = sharded.search(queries, 10)
    e_scores, e_ids, _ = single.search(queries, 10)
    assert_single_rule(s_scores, s_ids, e_scores, e_ids)


def test_global_df_semantics(corpus):
    # A term concentrated in one shard must still use GLOBAL df for idf.
    docs = port_docs(corpus[0][:64])
    sharded = ShardedIndex.build(docs, 8, device="cpu")
    single = build_sealed_segment(docs)
    for i, key in enumerate(single.token_keys):
        j = np.searchsorted(sharded.token_keys, key)
        assert sharded.token_keys[j] == key
        assert sharded.token_df[j] == single.token_df[i]


def test_payloads_and_empty_query(corpus):
    docs = port_docs(corpus[0][:40])
    payloads = (np.arange(40) * 3 + 7).tolist()
    sharded = ShardedIndex.build(docs, 8, payloads=payloads, device="cpu")
    scores, gids, pay = sharded.search([Query.from_int_ids([0])], 5)
    for g, p in zip(gids[0], pay[0]):
        if g >= 0:
            assert p == payloads[g]
    scores, gids, pay = sharded.search([Query.from_int_ids([12345])], 5)
    assert np.all(gids == -1)


def test_toy_anchor_all_engines():
    # The README toy-corpus anchor holds under sharding for every engine
    # (per-shard k is never capped by the shard size).
    from vectorchord_bm25_tpu.text.corpus import documents_from_texts
    from vectorchord_bm25_tpu.text.intern import random_seed
    from vectorchord_bm25_tpu.text.tokenizer import tsvector

    from test_tokenizer import TOY_CORPUS

    seed = random_seed()
    docs = port_docs(documents_from_texts(seed, TOY_CORPUS))
    q = Query(keys=RefQuery.from_tokens(seed, tsvector("PostgreSQL").keys()).keys)
    for engine in ("exact", "blockmax", "stream", "hybrid"):
        sharded = ShardedIndex.build(
            docs, 8, payloads=np.arange(1, 11), device="cpu", engine=engine
        )
        _, _, payloads = sharded.search([q], 10)
        assert [int(x) for x in payloads[0] if x >= 0] == [8, 9, 4, 1, 7, 2], engine


def test_set_deleted(corpus):
    docs = port_docs(corpus[0][:80])
    for engine in ("exact", "blockmax", "stream"):
        sharded = ShardedIndex.build(docs, 8, device="cpu", engine=engine)
        deleted = np.zeros(80, dtype=bool)
        deleted[:40] = True
        sharded.set_deleted(deleted)
        _, gids, _ = sharded.search([Query.from_int_ids([0, 1, 2, 3])], 30)
        valid = gids[0][gids[0] >= 0]
        assert valid.size > 0
        assert np.all(valid >= 40), engine
    with pytest.raises(ValueError):
        sharded.set_deleted(np.zeros(79, dtype=bool))


def test_global_stats_step(corpus):
    sharded = ShardedIndex.build(port_docs(corpus[0][:100]), 8, device="cpu")
    n, sdl, avgdl = sharded.global_stats_step()
    assert n == 100
    # Quantized sum: sum of decode(fieldnorm(dl)) <= sum of dl.
    assert 0 < sdl <= sharded.sum_dl and avgdl == sdl / n


def test_uniform_range_size_across_shards(corpus, monkeypatch):
    # The stacked tables decode doc = range*rs + local with ONE rs; shards
    # straddling the scale-aware default's threshold must share it.
    import vectorchord_bm25_tpu_torch.index.ranges as ranges_mod

    monkeypatch.setattr(ranges_mod, "default_range_size", lambda n: 64 if n < 26 else 128)
    docs = port_docs(corpus[0][:201])  # 8 shards: sizes 25 and 26
    single = ExactEngine(build_sealed_segment(docs), device="cpu")
    sharded = ShardedIndex.build(docs, 8, device="cpu", engine="blockmax")
    assert len({ri.range_size for ri in sharded._range_indexes}) == 1
    queries = [Query.from_int_ids(q) for q in corpus[1]]
    s_scores, s_ids, _ = sharded.search(queries, 10)
    e_scores, e_ids, _ = single.search(queries, 10)
    assert_single_rule(s_scores, s_ids, e_scores, e_ids)


def test_k_exceeds_per_round_candidate_pool():
    # The running top-k accumulates across rounds, so k may exceed one
    # round's candidate pool; the growing merge takes the wide result.
    gen = np.random.default_rng(11)
    docs = port_docs(make_ref_docs(gen, 2000, vocab=6))
    sharded = ShardedIndex.build(docs, 8, device="cpu", engine="blockmax")
    sharded.insert(Document.from_int_ids([0, 1]), payload=99999)
    single = ExactEngine(build_sealed_segment(docs), device="cpu")
    q = Query.from_int_ids([0, 1])
    k = 1000
    s_scores, s_ids, s_pay = sharded.search([q], k)
    assert s_scores.shape == (1, k)
    e_scores, e_ids, _ = single.search([q], k)
    mask = s_pay[0] != 99999
    got = s_ids[0][mask & (s_ids[0] >= 0)][: k - 1]
    expect = e_ids[0][e_ids[0] >= 0][: k - 1]
    assert got.size == min(k - 1, expect.size)
    # Ties may swap; everything else must match.
    assert np.isclose(s_scores[0][mask][: got.size], e_scores[0][: got.size], rtol=1e-4).all()


@pytest.fixture(scope="module")
def synth16k():
    from bench import synth_corpus_postings

    return synth_corpus_postings(16384, 8000, 50)


def test_stream_maxscore_matches_dense_and_reference(mesh8, synth16k, tmp_path):
    """strategy='maxscore': per-shard pruned search with tiered
    certification ranks exactly like the exhaustive sharded scan, with
    deletes and a prefilter.  Its scores equal the reference's exhaustive
    sharded scan bit for bit, and its work profile equals the reference's
    MaxScore.

    The reference's own sharded MaxScore returns the same ids but, for a
    query that reaches the second tier, lower scores: its rescore decodes
    with the width classes of the phase-1 prefix windows only
    (``parallel/shard.py:1180-1184, 1276-1281``), while the rescore reads
    windows outside that prefix too (the single-index rescore,
    ``search/stream.py:885-893``, keeps every width class), so some of
    that query's scores come out wrong.  The port's S5 reads each window's
    widths at run time.  The assertions on ``rm_s`` pin that difference
    (ROADMAP queue 3)."""
    from vectorchord_bm25_tpu_torch import load_sharded_index, save_sharded_index

    keys, doc_ids, tfs, doc_start = synth16k
    gen = np.random.default_rng(5)
    kw = dict(device="cpu", engine="stream", device_build=False)
    ms = ShardedIndex.build_from_postings(keys, doc_ids, tfs, doc_start, 8, strategy="maxscore", **kw)
    ex = ShardedIndex.build_from_postings(keys, doc_ids, tfs, doc_start, 8, strategy="dense", **kw)
    ref = {
        strategy: RefShardedIndex.build_from_postings(
            keys, doc_ids, tfs, doc_start, 8, strategy=strategy, mesh=mesh8,
            engine="stream", device_build=False,
        )
        for strategy in ("maxscore", "dense")
    }
    ids = [
        np.unique(np.concatenate([
            gen.integers(0, 12, size=1), gen.integers(12, 150, size=1),
            gen.integers(150, 8000, size=2),
        ])).tolist()
        for _ in range(16)
    ]
    queries = [Query.from_int_ids(q) for q in ids]
    for k in (1, 10):
        s_m, i_m, _ = ms.search(queries, k)
        s_e, i_e, _ = ex.search(queries, k)
        np.testing.assert_array_equal(i_m, i_e)
        f = np.isfinite(s_m)
        np.testing.assert_allclose(s_m[f], s_e[f], rtol=2e-6)
    rq = [RefQuery.from_int_ids(q) for q in ids]
    r_s, r_i, _ = ref["dense"].search(rq, 10)
    np.testing.assert_array_equal(s_m, r_s)
    np.testing.assert_array_equal(i_m, r_i)
    rm_s, rm_i, _ = ref["maxscore"].search(rq, 10)
    assert ms.last_ms_stats == ref["maxscore"].last_ms_stats
    st = ms.last_ms_stats
    assert st["tiers"] and st["tiers"][0]["pairs_certified"] > 0, st
    assert len(st["tiers"]) == 2 and st["tiers"][1]["queries"] == 1, st
    np.testing.assert_array_equal(rm_i, r_i)
    under = np.flatnonzero((rm_s != r_s).any(axis=1))
    assert under.size == 1 and st["tiers"][1]["queries"] == 1
    # Deletes + prefilter keep the certification conservative.
    deleted = gen.random(16384) < 0.4
    ms.set_deleted(deleted)
    ex.set_deleted(deleted)
    keep = gen.random(16384) < 0.5
    fil = lambda pl: keep[pl]  # noqa: E731
    _, i_m, _ = ms.search(queries, 10, filter_fn=fil)
    _, i_e, _ = ex.search(queries, 10, filter_fn=fil)
    np.testing.assert_array_equal(i_m, i_e)
    # The checkpoint round-trips the strategy.
    save_sharded_index(ms, str(tmp_path))
    assert load_sharded_index(str(tmp_path), device="cpu").strategy == "maxscore"


def test_maxscore_per_shard_fallback(synth16k, monkeypatch):
    """An uncertified shard does not force the whole query through the
    exhaustive scan: certified shards' exact local top-ks are kept and only
    the uncertified shards rescan; results still rank like the scan."""
    from vectorchord_bm25_tpu_torch import StreamEngine

    keys, doc_ids, tfs, doc_start = synth16k
    gen = np.random.default_rng(6)
    kw = dict(device="cpu", engine="stream", device_build=False)
    ms = ShardedIndex.build_from_postings(keys, doc_ids, tfs, doc_start, 8, strategy="maxscore", **kw)
    ex = ShardedIndex.build_from_postings(keys, doc_ids, tfs, doc_start, 8, strategy="dense", **kw)
    # One high-tau tier with a shallow pool: heavy queries cannot certify.
    monkeypatch.setattr(StreamEngine, "MS_TIERS", ((0.95, 16, 0.0),))
    queries = [
        Query.from_int_ids(np.unique(np.concatenate([
            gen.integers(0, 12, size=2), gen.integers(150, 8000, size=2),
        ])).tolist())
        for _ in range(12)
    ]
    s_m, i_m, _ = ms.search(queries, 10)
    s_e, i_e, _ = ex.search(queries, 10)
    np.testing.assert_array_equal(i_m, i_e)
    f = np.isfinite(s_m)
    np.testing.assert_allclose(s_m[f], s_e[f], rtol=2e-6)
    st = ms.last_ms_stats
    assert st["fallback_queries"] > 0, st
    assert st["fallback_windows_skipped"] > 0 and st["fallback_windows_scanned"] > 0, st


@pytest.mark.parametrize("source", ["random", "synth"])
def test_compact_layout_of_sharded_planning(corpus, synth16k, source):
    # The group matrices the sharded `_prepare_compact` writes keep, in
    # every shard, the layout E3 relies on (csrc/exact_compact.cu).
    from test_torch_exact import assert_compact_layout

    gen = np.random.default_rng(11)
    if source == "random":
        docs, ids, _, _ = corpus
        built = ShardedIndex.build(port_docs(docs), 8, device="cpu", engine="hybrid")
    else:
        keys, doc_ids, tfs, doc_start = synth16k
        built = ShardedIndex.build_from_postings(
            keys, doc_ids, tfs, doc_start, 8, device="cpu", engine="hybrid",
            device_build=False,
        )
        ids = [gen.integers(0, 300, size=int(n)).tolist() for n in gen.integers(1, 6, size=24)]
    index = ShardedIndex(
        [v.segment for v in built.views], built.options, device="cpu",
        engine="hybrid", memory_mode="compact", seed=built.seed,
    )
    grp_ids, grp_ord = index._prepare_compact([Query.from_int_ids(q) for q in ids])
    assert (grp_ord >= 0).any()
    for si in range(index.n_shards):
        assert_compact_layout(
            grp_ids[si], grp_ord[si], index.dev_bm_tr_range[si].numpy(), index._nmax, index._rs
        )


@pytest.mark.parametrize("entry", ["documents", "postings"])
def test_host_build_equals_device_build_and_reference(mesh8, entry):
    gen = np.random.default_rng(9)
    docs = make_ref_docs(gen, 203, vocab=14)
    if entry == "documents":
        host = ShardedIndex.build(port_docs(docs), 8, device="cpu", device_build=False)
        dev = ShardedIndex.build(port_docs(docs), 8, device="cpu")  # the default
        ref = RefShardedIndex.build(docs, 8, mesh=mesh8, device_build=True)
    else:
        keys = np.concatenate([d.keys for d in docs])
        tfs = np.concatenate([d.values for d in docs]).astype(np.int64)
        counts = np.array([len(d) for d in docs])
        doc_ids = np.repeat(np.arange(len(docs)), counts)
        doc_start = np.concatenate(([0], np.cumsum(counts)))
        args = (keys, doc_ids, tfs, doc_start, 8)
        host = ShardedIndex.build_from_postings(*args, device="cpu", device_build=False)
        dev = ShardedIndex.build_from_postings(*args, device="cpu", device_build=True)
        ref = RefShardedIndex.build_from_postings(*args, mesh=mesh8, device_build=True)
    for vh, vd, vr in zip(host.views, dev.views, ref.views):
        assert_segments_equal(vh.segment, vd.segment)
        assert_segments_equal(vd.segment, vr.segment)
        assert vd.doc_offset == vr.doc_offset


def test_device_doc_offsets_agree_with_the_reference(mesh8):
    from vectorchord_bm25_tpu.parallel.devbuild import device_doc_offsets as ref_offsets
    from vectorchord_bm25_tpu_torch.parallel.devbuild import device_doc_offsets

    counts = np.array([26, 25, 25, 26, 0, 25, 25, 51], dtype=np.int64)
    np.testing.assert_array_equal(device_doc_offsets(counts, "cpu"), ref_offsets(counts, mesh8))


@pytest.mark.parametrize("engine", ["stream", "blockmax"])
def test_from_reference_carries_state(mesh8, corpus, engine):
    docs, ids, deleted, _ = corpus
    ref = RefShardedIndex.build(docs, 8, mesh=mesh8, engine=engine)
    ref.set_deleted(deleted)
    ref.insert(docs[3], 7777)
    ref.insert(docs[4], 7778)
    ref.bulkdelete_payloads([7778])
    port = ShardedIndex.from_reference(ref, device="cpu")
    assert port.seed == ref.seed and port.engine == ref.engine
    assert np.array_equal(port.deleted, ref.deleted)
    assert port.growing.deleted == ref.growing.deleted
    for vp, vr in zip(port.views, ref.views):
        assert_segments_equal(vp.segment, vr.segment)
    want = ref.search([RefQuery.from_int_ids(q) for q in ids], 10)
    got = port.search([Query.from_int_ids(q) for q in ids], 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_constructors_default_to_the_card():
    import inspect

    from vectorchord_bm25_tpu_torch import load_sharded_index, open_sharded_index
    from vectorchord_bm25_tpu_torch.parallel import devbuild

    for fn in (
        ShardedIndex.__init__, ShardedIndex.build, ShardedIndex.build_from_postings,
        ShardedIndex.from_reference, load_sharded_index, open_sharded_index,
        devbuild.build_shards_on_device, devbuild.build_shards_on_device_from_postings,
        devbuild.device_doc_offsets,
    ):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
