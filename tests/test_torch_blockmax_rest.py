"""The rest of the Block-Max engine on the port vs the reference, on the CPU:
bf16 impacts, ``posting_mode="tf"`` and the exhaustive range sweep
(``search_rangescan_async``).

Replays the cases of tests/test_rangescan.py (all but the HybridEngine
one, whose engine is not ported), tests/test_bf16_impacts.py (the
Block-Max case) and ``TestTfPostingMode`` (tests/test_blockmax.py), each
on the port against the reference on the same segment and RangeIndex:
equal ids and payloads and bit-equal scores.  Where the reference runs P1
it runs it in Pallas interpret mode; in tf mode it runs its own scatter.
Then the plain versions of P1-bf16 and P1-tf in lockstep with the
reference's arithmetic on the same windows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.ops.score_kernel import (  # noqa: E402
    fused_range_scores as ref_fused_range_scores,
)
from vectorchord_bm25_tpu.search.blockmax import (  # noqa: E402
    BlockMaxEngine as RefEngine,
)
from vectorchord_bm25_tpu.search.exact import ExactEngine  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import score_kernel  # noqa: E402
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402

from test_fuzz import edit_distance  # noqa: E402
from test_sealed import make_docs  # noqa: E402

torch.set_num_threads(2)


def engines(seg, ri=None, **kw):
    """The reference (P1 in interpret mode; tf mode forces its scatter)
    and the port on the CPU, over one segment and RangeIndex."""
    ri = ri or build_range_index(seg)
    ref = RefEngine(seg, ri, use_pallas="interpret", **kw)
    port = BlockMaxEngine(seg, ri, device="cpu", **kw)
    return ref, port


def assert_same(got, want):
    """Equal ids and payloads, bit-equal scores."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def rand_queries(rng, n, vocab, size=3):
    return [
        Query.from_int_ids(rng.integers(0, vocab, size=size).tolist())
        for _ in range(n)
    ]


# --- tests/test_rangescan.py


def _dense_parity(seg, got, queries, k, **kw):
    # The reference test's own check: the exhaustive sweep is exact.
    s_d, i_d, _ = ExactEngine(seg, strategy="dense").search(queries, k, **kw)
    s_r, i_r, _ = got
    np.testing.assert_array_equal(i_r >= 0, i_d >= 0)
    np.testing.assert_allclose(s_r, s_d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_docs,vocab", [(300, 8), (900, 30)])
def test_rangescan_matches_dense(rng, n_docs, vocab):
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    ref, port = engines(seg)
    queries = rand_queries(rng, 12, vocab)
    got = assert_same(
        port.search_rangescan_async(queries, 10)(),
        ref.search_rangescan_async(queries, 10)(),
    )
    _dense_parity(seg, got, queries, 10)
    # Exhaustive and pruned agree exactly.
    assert_same(got, port.search(queries, 10))


def test_rangescan_pallas_interpret(rng):
    seg = build_sealed_segment(make_docs(rng, 200, vocab=6))
    ref, port = engines(seg)
    queries = [Query.from_int_ids([0, 1, 2]), Query.from_int_ids([3, 4])]
    got = assert_same(
        port.search_rangescan_async(queries, 8)(),
        ref.search_rangescan_async(queries, 8)(),
    )
    _dense_parity(seg, got, queries, 8)


def test_rangescan_filter_and_deleted(rng):
    docs = make_docs(rng, 250, vocab=6)
    seg = build_sealed_segment(docs)
    ref, port = engines(seg)
    deleted = np.zeros(len(docs), dtype=bool)
    deleted[rng.integers(0, len(docs), size=60)] = True
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    fmask = rng.random(len(docs)) < 0.5
    queries = rand_queries(rng, 6, 6)
    _, i_r, _ = assert_same(
        port.search_rangescan_async(queries, 10, fmask)(),
        ref.search_rangescan_async(queries, 10, fmask)(),
    )
    live = ~deleted & fmask
    assert (i_r >= 0).any()
    for qi in range(len(queries)):
        for d in i_r[qi][i_r[qi] >= 0]:
            assert live[d]


def test_rangescan_missing_terms_and_empty(rng):
    seg = build_sealed_segment(make_docs(rng, 100, vocab=5))
    ref, port = engines(seg)
    queries = [Query.from_int_ids([99999]), Query(keys=np.zeros(0, dtype="S16"))]
    s, i, p = assert_same(
        port.search_rangescan_async(queries, 5)(),
        ref.search_rangescan_async(queries, 5)(),
    )
    assert np.all(i == -1) and np.all(p == -1)


def test_rangescan_rejects_tf_mode(rng):
    seg = build_sealed_segment(make_docs(rng, 60, vocab=5))
    port = BlockMaxEngine(seg, device="cpu", posting_mode="tf")
    with pytest.raises(ValueError, match="impact"):
        port.search_rangescan_async([Query.from_int_ids([1])], 5)


@pytest.mark.parametrize("range_size", [32, 128])
def test_rangescan_many_chunks_and_bf16(rng, range_size):
    # Several chunks and a row width that is not a multiple of 4 floats
    # (chunk * RS = 3 * 32 at n_ranges 3): the accumulator's padded row
    # stride; and bf16 impacts through the sweep.
    n_docs = 3 * range_size - 5
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=12))
    ri = build_range_index(seg, range_size=range_size)
    queries = rand_queries(rng, 9, 12, size=4)
    for kw in ({}, {"impact_dtype": "bfloat16"}):
        ref, port = engines(seg, ri, **kw)
        assert_same(
            port.search_rangescan_async(queries, 7)(),
            ref.search_rangescan_async(queries, 7)(),
        )


# --- tests/test_bf16_impacts.py


def test_bf16_ranks_close_to_f32(rng):
    seg = build_sealed_segment(make_docs(rng, 300, vocab=20))
    ri = build_range_index(seg)
    ref, port = engines(seg, ri, impact_dtype="bfloat16")
    f32 = BlockMaxEngine(seg, ri, device="cpu")
    queries = rand_queries(rng, 6, 20)
    s2, i2, _ = assert_same(port.search(queries, 20), ref.search(queries, 20))
    s1, i1, _ = f32.search(queries, 20)
    for qi in range(len(queries)):
        g1 = [int(x) for x in i1[qi] if x >= 0]
        g2 = [int(x) for x in i2[qi] if x >= 0]
        assert len(g1) == len(g2)
        # bf16 rounding (~0.4% relative) may swap near-ties only.
        assert edit_distance(g1, g2) <= 6
        np.testing.assert_allclose(s2[qi][: len(g2)], s1[qi][: len(g1)], rtol=6e-3)


def test_bf16_device_bytes_halve(rng):
    seg = build_sealed_segment(make_docs(rng, 100, vocab=10))
    ref, bf16 = engines(seg, impact_dtype="bfloat16")
    assert bf16.dev_post_impact.dtype == torch.bfloat16
    # The same bits as the reference's cast.
    np.testing.assert_array_equal(
        bf16.dev_post_impact.view(torch.int16).numpy(),
        np.asarray(ref.dev_post_impact).view(np.int16),
    )
    np.testing.assert_array_equal(bf16.dev_tr_ub.numpy(), np.asarray(ref.dev_tr_ub))
    f32 = BlockMaxEngine(seg, device="cpu")
    assert bf16.dev_post_impact.nbytes * 2 == f32.dev_post_impact.nbytes
    assert bf16.memory_report() == ref.memory_report()


# --- TestTfPostingMode (tests/test_blockmax.py)


@pytest.mark.parametrize("n_docs,vocab", [(300, 20), (500, 8)])
def test_tf_matches_impact_mode(rng, n_docs, vocab):
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    ri = build_range_index(seg)
    ref, tfm = engines(seg, ri, chunk=4, posting_mode="tf")
    imp = BlockMaxEngine(seg, ri, chunk=4, device="cpu")
    queries = rand_queries(rng, 6, vocab)
    for k in (1, 10):
        s2, i2, _ = assert_same(tfm.search(queries, k), ref.search(queries, k))
        s1, i1, _ = imp.search(queries, k)
        np.testing.assert_array_equal(i1 >= 0, i2 >= 0)
        np.testing.assert_allclose(s2, s1, rtol=1e-5)


def test_tf_deletes_and_filters(rng):
    seg = build_sealed_segment(make_docs(rng, 200, vocab=10))
    ref, tfm = engines(seg, posting_mode="tf")
    deleted = rng.random(200) < 0.25
    ref.set_deleted(deleted)
    tfm.set_deleted(deleted)
    fmask = rng.random(200) < 0.5
    queries = [Query.from_int_ids([0, 1, 2])]
    _, ids, _ = assert_same(
        tfm.search(queries, 10, filter_mask=fmask),
        ref.search(queries, 10, filter_mask=fmask),
    )
    live = ids[ids >= 0]
    assert live.size and np.all(~deleted[live] & fmask[live])


def test_tf_u16_fallback_when_tf_overflows_u8():
    def doc(pairs):
        return Document(
            keys=np.asarray([k for k, _ in pairs], dtype="S16"),
            values=np.asarray([v for _, v in pairs], dtype=np.uint32),
        )

    docs = [
        doc([(b"aaa", 300), (b"bbb", 2)]),
        doc([(b"aaa", 1)]),
        doc([(b"bbb", 5)]),
    ]
    seg = build_sealed_segment(docs)
    ref, tfm = engines(seg, posting_mode="tf")
    # u16 term frequencies travel as the same bits in int16.
    assert np.asarray(ref.dev_post_tf).dtype == np.uint16
    assert tfm.dev_post_tf.dtype == torch.int16
    np.testing.assert_array_equal(
        tfm.dev_post_tf.numpy().view(np.uint16), np.asarray(ref.dev_post_tf)
    )
    q = Query(keys=np.asarray([b"aaa", b"bbb"], dtype="S16"))
    s2, i2, _ = assert_same(tfm.search([q], 3), ref.search([q], 3))
    s1, i1, _ = ExactEngine(seg).search([q], 3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)


def test_tf_memory_two_bytes_per_posting(rng):
    seg = build_sealed_segment(make_docs(rng, 2000, vocab=50))
    ri = build_range_index(seg)
    ref, tfm = engines(seg, ri, posting_mode="tf")
    imp = BlockMaxEngine(seg, ri, device="cpu")
    r_imp, r_tf = imp.memory_report(), tfm.memory_report()
    assert r_tf == ref.memory_report()
    n_post = int(seg.block_n.sum())
    # 2 B/posting (+ pad tail) vs 5 B/posting.
    assert r_tf["postings"] <= 2 * (n_post + 512)
    assert r_tf["postings"] < r_imp["postings"] / 2
    assert r_tf["total"] < r_imp["total"]


# --- the plain versions in lockstep with the reference's arithmetic


def _index_windows(rng, seg, ri, q=12, t=4, c=6):
    """[Q, T, C] spans of real (term, range) groups, candidate ranges
    [Q, C] and per-term s0 [Q, T], as the engine hands them out: absent
    groups get start 0 and length 0."""
    starts = np.zeros((q, t, c), dtype=np.int32)
    lens = np.zeros((q, t, c), dtype=np.int32)
    cand = np.zeros((q, c), dtype=np.int32)
    s0 = np.zeros((q, t), dtype=np.float32)
    tok_s0 = seg.token_s0().astype(np.float32)
    for qi in range(q):
        terms = rng.choice(seg.n_tokens, size=t, replace=False)
        cand[qi] = rng.choice(ri.n_ranges, size=c, replace=ri.n_ranges < c)
        s0[qi] = tok_s0[terms]
        for ti, tid in enumerate(terms):
            lo, hi = ri.token_tr_start[tid], ri.token_tr_start[tid + 1]
            term_ranges = ri.tr_range[lo:hi]
            for ci, r in enumerate(cand[qi]):
                j = np.searchsorted(term_ranges, r)
                if j < term_ranges.size and term_ranges[j] == r:
                    starts[qi, ti, ci] = ri.tr_start[lo + j]
                    lens[qi, ti, ci] = ri.tr_len[lo + j]
    assert lens.any()
    return starts, lens, cand, s0


def _ref_tf_scatter(post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, start, length, rs, n_docs):
    """search/blockmax.py:166-192 of the reference (its tf-mode round),
    in jnp on the same inputs."""
    import jax

    q, t, c = start.shape
    rs_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, rs), 3)
    gidx = start[..., None] + rs_iota
    valid = rs_iota < length[..., None]
    local = post_local[gidx].astype(jnp.int32)
    tval = jnp.where(valid, post_tf[gidx].astype(jnp.float32), 0.0)
    doc_l = jnp.minimum(cand_r[:, None, :, None] * rs + local, n_docs)
    fnv = doc_fn[doc_l].astype(jnp.int32)
    sc = (tval * q_s0[:, :, None, None]) / (tval + s1_table[fnv])
    qi = jax.lax.broadcasted_iota(jnp.int32, (q, t, c, rs), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (q, t, c, rs), 2)
    acc = jnp.zeros((q, c, rs), dtype=jnp.float32)
    return acc.at[qi, ci, local].add(sc)


@pytest.mark.parametrize("tf_scale,rs", [(1, 128), (1, 32), (300, 128)])
def test_tf_plain_lockstep_with_reference(rng, tf_scale, rs):
    docs = make_docs(rng, 1500, vocab=30)
    docs[3] = Document(keys=docs[3].keys, values=docs[3].values * tf_scale)
    seg = build_sealed_segment(docs)
    ri = build_range_index(seg, range_size=rs)
    ref = RefEngine(seg, ri, posting_mode="tf")
    port = BlockMaxEngine(seg, ri, device="cpu", posting_mode="tf")
    starts, lens, cand, s0 = _index_windows(rng, seg, ri)
    want = np.asarray(
        _ref_tf_scatter(
            ref.dev_post_tf, ref.dev_post_local, ref.dev_doc_fn, ref.dev_s1,
            jnp.asarray(s0), jnp.asarray(cand), jnp.asarray(starts),
            jnp.asarray(lens), rs, seg.n_docs,
        )
    )
    before = score_kernel.TF_LAUNCHES
    got = score_kernel.tf_range_scores(
        port.dev_post_tf, port.dev_post_local, port.dev_doc_fn, port.dev_s1,
        *(torch.from_numpy(x) for x in (s0, cand, starts, lens)),
        rs=rs, n_docs=seg.n_docs,
    ).numpy()
    assert score_kernel.TF_LAUNCHES == before  # a CPU tensor launches nothing
    assert np.array_equal(got, want)
    assert (got > 0).any()


def test_tf_plain_reproduces_stray_lanes(rng):
    # Lanes past a window's length read stray postings: the reference adds
    # their 0/s1 at the slot each names, and with b = 1 a zero-length
    # fieldnorm makes that 0/0 = NaN.  The plain version reproduces both.
    from vectorchord_bm25_tpu.utils.options import IndexOptions

    docs = make_docs(rng, 300, vocab=10)
    docs[299] = Document(keys=np.zeros(0, dtype="S16"), values=np.zeros(0, np.uint32))
    for b in (0.75, 1.0):
        seg = build_sealed_segment(docs, options=IndexOptions(b=b))
        ri = build_range_index(seg, range_size=64)
        ref = RefEngine(seg, ri, posting_mode="tf")
        port = BlockMaxEngine(seg, ri, device="cpu", posting_mode="tf")
        p = ri.post_local.size
        starts = rng.integers(0, p - 64, size=(3, 2, 5)).astype(np.int32)
        lens = rng.integers(0, 65, size=(3, 2, 5)).astype(np.int32)
        cand = rng.integers(0, ri.n_ranges, size=(3, 5)).astype(np.int32)
        cand[0, 0] = ri.n_ranges - 1  # reaches the pad doc
        s0 = (rng.random((3, 2)) * 3).astype(np.float32)
        want = np.asarray(
            _ref_tf_scatter(
                ref.dev_post_tf, ref.dev_post_local, ref.dev_doc_fn, ref.dev_s1,
                *(jnp.asarray(x) for x in (s0, cand, starts, lens)), 64, seg.n_docs,
            )
        )
        got = score_kernel.tf_range_scores_plain(
            port.dev_post_tf, port.dev_post_local, port.dev_doc_fn, port.dev_s1,
            *(torch.from_numpy(x) for x in (s0, cand, starts, lens)),
            rs=64, n_docs=seg.n_docs,
        ).numpy()
        np.testing.assert_array_equal(got, want)  # NaN == NaN here
        assert np.isnan(got).any() == (b == 1.0)


@pytest.mark.parametrize("rs", [128, 64])
def test_bf16_plain_lockstep_with_reference(rng, rs):
    seg = build_sealed_segment(make_docs(rng, 2000, vocab=40))
    ri = build_range_index(seg, range_size=rs)
    ref, port = engines(seg, ri, impact_dtype="bfloat16")
    starts, lens, _, _ = _index_windows(rng, seg, ri)
    want = np.asarray(
        ref_fused_range_scores(
            ref.dev_post_impact, ref.dev_post_local, starts, lens, rs=rs,
            interpret=True,
        )
    )
    got = score_kernel.fused_range_scores_plain(
        port.dev_post_impact, port.dev_post_local,
        torch.from_numpy(starts), torch.from_numpy(lens), rs=rs,
    ).numpy()
    assert np.array_equal(got, want)
    # The strided form writes the same rows into a wider matrix.
    q, _, c = starts.shape
    wide = torch.full((q, 2 * c * rs + 3), -1.0)
    score_kernel.fused_range_scores(
        port.dev_post_impact, port.dev_post_local,
        torch.from_numpy(starts), torch.from_numpy(lens), rs=rs,
        out=wide[:, c * rs : 2 * c * rs],
    )
    assert np.array_equal(wide[:, c * rs : 2 * c * rs].numpy().reshape(q, c, rs), want)
    assert bool((wide[:, : c * rs] == -1).all())


# --- through the facade, as a user builds it


@pytest.mark.parametrize(
    "opts", [{"impact_dtype": "bfloat16"}, {"posting_mode": "tf"}], ids=["bf16", "tf"]
)
def test_facade_modes_equal_reference(rng, opts):
    from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex
    from vectorchord_bm25_tpu.text.intern import random_seed
    from vectorchord_bm25_tpu.utils.options import SessionConfig
    from vectorchord_bm25_tpu_torch import Bm25Index

    docs = make_docs(rng, 1500, vocab=80)
    payloads = (np.arange(1500) * 5 + 1).tolist()
    seed = random_seed()
    ref = RefIndex.build(
        docs, payloads=payloads, seed=seed, engine="blockmax",
        engine_options={"use_pallas": "interpret", "chunk": 4, **opts},
    )
    port = Bm25Index.build(
        docs, payloads=payloads, seed=seed, engine="blockmax",
        engine_options={"chunk": 4, **opts}, device="cpu",
    )
    queries = rand_queries(rng, 24, 80)

    def hits(index, **kw):
        return [[(h.score, h.payload) for h in r] for r in index.search_batch(queries, 10, **kw)]

    assert hits(port) == hits(ref)
    assert port.engine().memory_report() == ref.engine().memory_report()
    assert port.bulkdelete(lambda p: p % 7 == 0) == ref.bulkdelete(lambda p: p % 7 == 0)
    sess = SessionConfig(prefilter=True)
    kw = {"filter_fn": lambda p: p % 3 != 0, "session": sess}
    got = hits(port, **kw)
    assert got == hits(ref, **kw) and sum(map(len, got)) > 0
