"""The stream engine's sparse and MaxScore strategies: port vs reference.

The reference runs its jnp kernels on the CPU, as tests/test_stream.py
runs them; the port runs the plain versions of S3 (``stream_sparse_decode``),
S4 (``sparse_combine``) and S5 (``stream_rescore``), which a CPU tensor
dispatches to.  Decode and run sums add in the reference's order, so the
sparse reduction is bit-equal, ids and scores.  The rescore adds the terms
in ascending order where the reference's ``jnp.sum`` takes XLA's, so its
scores are held to rtol 2e-6 (the tolerance tests/test_stream.py uses
between the two strategies) and its ids exactly.  Replays every
``TestStreamEngine.test_vs_oracle`` strategy and the four ``TestMaxScore``
cases, comparing ``search`` and ``last_ms_stats`` with the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vectorchord_bm25_tpu.index.sealed import (  # noqa: E402
    build_sealed_segment_from_postings,
)
from vectorchord_bm25_tpu.index.stream import build_stream_index  # noqa: E402
from vectorchord_bm25_tpu.search.exact import oracle_topk  # noqa: E402
from vectorchord_bm25_tpu.search.stream import (  # noqa: E402
    StreamEngine as RefEngine,
    _active_widths,
    _stream_rescore,
    _stream_sparse,
    _unpack_and_score,
)
from vectorchord_bm25_tpu.text.intern import Query  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import stream_rescore, stream_sparse, topk  # noqa: E402
from vectorchord_bm25_tpu_torch.search.stream import StreamEngine  # noqa: E402

from test_stream import random_segment  # noqa: E402
from test_torch_stream_kernel import (  # noqa: E402
    big_gap_segment,
    port_tensors,
    s1_eff_of,
    tables,
    width_segment,
)

torch.set_num_threads(2)


def ref_tables(si, s1_eff):
    off, base, meta, s0 = tables(si)
    return tuple(
        jnp.asarray(x) for x in (si.words, s1_eff, off, base, meta, s0)
    )


def window_matrix(si, query_terms):
    """The sparse path's [Q, P] window matrix (as ``_assemble`` lays it):
    each query's term spans term-major, padded with the pad window W to
    at least 8 columns.  Returns (matrix, most terms in a query)."""
    tws = si.token_w_start
    rows = [
        np.concatenate([np.arange(tws[t], tws[t + 1]) for t in terms] or [[]])
        for terms in query_terms
    ]
    mat = np.full((len(rows), max(8, max(r.size for r in rows))), si.n_windows, np.int32)
    for i, r in enumerate(rows):
        mat[i, : r.size] = r
    return mat, max(1, max(len(t) for t in query_terms))


def segment_case(name, rng):
    """(stream index, per-query term lists, dead fraction) of a named case."""
    if name == "big_gaps_tf16":
        si = build_stream_index(big_gap_segment(rng))
        return si, [[0, 1, 2], [0], [2, 1], [1, 1, 1], []], 0.0
    tf_hi = {"tf1": 1, "mixed_widths": 15, "tf16": 400, "deletes": 15}[name]
    si = build_stream_index(width_segment(rng, tf_hi, n_docs=20_000))
    terms = [[1, 1, 2], [0, 3, 3, 3, 5]] + [
        rng.integers(0, si.n_tokens, size=int(rng.integers(1, 5))).tolist()
        for _ in range(6)
    ]
    return si, terms, 0.3 if name == "deletes" else 0.05


SEGMENT_CASES = ["tf1", "mixed_widths", "tf16", "big_gaps_tf16", "deletes"]


@pytest.mark.parametrize("case", SEGMENT_CASES[:4])
def test_decode_equals_reference_unpack(rng, case):
    # S3's plain version against M1 in the sparse layout (search/stream.py
    # :327-332), every lane, dead and pad lanes included.
    si, terms, dead_frac = segment_case(case, rng)
    s1_eff, _ = s1_eff_of(si, rng, dead_frac)
    mat, _ = window_matrix(si, terms)
    words, s1, off, base, meta, s0 = ref_tables(si, s1_eff)
    r_doc, r_sc = _unpack_and_score(
        words, s1, off[mat], base[mat], meta[mat], s0[mat], si.n_docs
    )
    doc, sc = stream_sparse.stream_sparse_decode(
        *port_tensors(si, s1_eff), torch.from_numpy(mat), si.n_docs
    )
    assert doc.shape == sc.shape == (mat.shape[0], mat.shape[1] * 128)
    np.testing.assert_array_equal(doc.numpy(), np.asarray(r_doc).reshape(doc.shape))
    assert np.array_equal(sc.numpy(), np.asarray(r_sc).reshape(sc.shape))
    pad = np.repeat(mat == si.n_windows, 128, axis=1)
    assert pad.any() and np.all(doc.numpy()[pad] == si.n_docs)
    assert np.all(sc.numpy()[doc.numpy() == si.n_docs] == 0.0)


@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("k_case", ["k16", "k_above_lanes"])
def test_sparse_topk_equals_reference(rng, case, k_case):
    # S3 -> stable sort -> S4 -> selection against _stream_sparse, whole
    # arrays: scores bit-equal, ids equal (the -inf pads' too).  Repeated
    # terms make runs longer than a query's distinct terms; a k above a
    # row's lanes selects kk < k and pads.
    si, terms, dead_frac = segment_case(case, rng)
    s1_eff, _ = s1_eff_of(si, rng, dead_frac)
    mat, mt = window_matrix(si, terms)
    k = 16 if k_case == "k16" else mat.shape[1] * 128 + 100
    seg_steps = int(mt - 1).bit_length()
    dw, tw = _active_widths(si.w_meta[mat[mat < si.n_windows]])
    r_s, r_i = _stream_sparse(
        *ref_tables(si, s1_eff), jnp.asarray(mat), k=k, n_docs=si.n_docs,
        seg_steps=seg_steps, dwidths=dw, twidths=tw,
    )
    s, i = stream_sparse.stream_sparse_topk(
        *port_tensors(si, s1_eff), torch.from_numpy(mat), k, si.n_docs, seg_steps
    )
    assert s.shape == i.shape == (mat.shape[0], k) and i.dtype == torch.int32
    assert np.array_equal(s.numpy(), np.asarray(r_s))
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    assert np.isfinite(s.numpy()).sum() > mat.shape[0]


def test_run_sums_follow_the_reference_scan():
    # Runs of 3 and 4 lanes sum as the Hillis-Steele scan does, (c+b)+a and
    # (d+c)+(b+a), not left to right; a lane past 2^seg_steps is not
    # reached, a zero sum and a pad doc are no candidates.
    a, b = np.float32(1.0), np.float32(2.0**-24)
    n = 100
    df = torch.tensor([[3, 5, 5, 5, 7, 7, 7, 7, 8, 9, n, n]], dtype=torch.int32)
    sf = torch.tensor(
        [[0.5, a, b, b, a, b, b, a, 0.0, 2.0, 0.0, 0.0]], dtype=torch.float32
    )
    keys = stream_sparse.sparse_combine(df, sf, n, 2)
    s, ids = topk.select_keys(keys, 12)
    # Four candidates first, score desc; then the other lanes' pad keys.
    assert s[0, :4].isfinite().all() and s[0, 4:].isinf().all()
    got = dict(zip(ids[0, :4].tolist(), s[0, :4].tolist()))
    f = np.float32
    assert got[5] == f(f(b + b) + a) and f(f(a + b) + b) == a != got[5]
    assert got[7] == f(f(a + b) + f(b + a))
    assert got[3] == 0.5 and got[9] == 2.0
    assert s[0, :4].tolist() == sorted(s[0, :4].tolist(), reverse=True)
    assert ids[0, 4:].tolist() == [5, 5, 7, 7, 7, 8, n, n]
    # seg_steps = 1 reaches two lanes of each run: 7's last two, b + a.
    s1, i1 = topk.select_keys(stream_sparse.sparse_combine(df, sf, n, 1), 4)
    assert dict(zip(i1[0].tolist(), s1[0].tolist()))[7] == f(a + b)


def test_sparse_kernels_reject_bad_inputs(rng):
    si, terms, _ = segment_case("tf1", rng)
    s1_eff, _ = s1_eff_of(si, rng)
    mat, _ = window_matrix(si, terms)
    args = port_tensors(si, s1_eff)
    with pytest.raises(TypeError, match="wsrc"):
        stream_sparse.stream_sparse_decode(*args, torch.from_numpy(mat).long(), si.n_docs)
    with pytest.raises(ValueError, match="wsrc"):
        stream_sparse.stream_sparse_decode(*args, torch.from_numpy(mat[0]), si.n_docs)
    df = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="seg_steps"):
        stream_sparse.sparse_combine(df, torch.zeros((2, 8)), 5, 31)
    with pytest.raises(ValueError, match="must match"):
        stream_sparse.sparse_combine(df, torch.zeros((2, 4)), 5, 1)


def rescore_case(si, rng, query_terms, c=40):
    """MaxScore phase 2's inputs as ``_ms_tier`` builds them: sorted
    candidates per query (postings of its terms, random docs and n_docs
    pads) and [Q, T] window spans, pad terms empty."""
    tws = si.token_w_start
    tmax = max(2, 1 << (max(len(t) for t in query_terms) - 1).bit_length())
    t_lo = np.zeros((len(query_terms), tmax), np.int32)
    t_hi = np.zeros((len(query_terms), tmax), np.int32)
    cand = np.full((len(query_terms), c), si.n_docs, np.int64)
    for q, terms in enumerate(query_terms):
        docs = [np.zeros(0, np.int64)]
        for j, t in enumerate(terms):
            t_lo[q, j], t_hi[q, j] = tws[t], tws[t + 1]
            for w in range(tws[t], min(tws[t + 1], tws[t] + 3)):
                docs.append(si.decode_window(w)[0])
        pool = np.unique(np.concatenate(docs + [rng.integers(0, si.n_docs, 8)]))
        pick = rng.choice(pool, size=min(c - 4, pool.size), replace=False)
        cand[q, : pick.size] = pick
    cand.sort(axis=1)
    return cand.astype(np.int32), t_lo, t_hi


@pytest.mark.parametrize("case", SEGMENT_CASES[1:])
def test_rescore_equals_reference(rng, case):
    si, terms, dead_frac = segment_case(case, rng)
    terms = [t for t in terms if t]
    s1_eff, _ = s1_eff_of(si, rng, dead_frac)
    cand, t_lo, t_hi = rescore_case(si, rng, terms)
    bs_steps = int(np.max(t_hi - t_lo, initial=1)).bit_length() + 1
    for k in (10, cand.shape[1] + 5):  # the second ranks every candidate
        r_s, r_i = _stream_rescore(
            *ref_tables(si, s1_eff), jnp.asarray(cand), jnp.asarray(t_lo),
            jnp.asarray(t_hi), k=k, n_docs=si.n_docs, bs_steps=bs_steps,
        )
        s, i = stream_rescore.rescore_topk(
            *port_tensors(si, s1_eff), torch.from_numpy(cand),
            torch.from_numpy(t_lo), torch.from_numpy(t_hi), k, si.n_docs,
        )
        r_s, r_i = np.asarray(r_s), np.asarray(r_i)
        np.testing.assert_array_equal(i.numpy(), r_i)
        np.testing.assert_array_equal(np.isfinite(s.numpy()), np.isfinite(r_s))
        live = np.isfinite(r_s)
        assert live.sum() >= len(terms)
        np.testing.assert_allclose(s.numpy()[live], r_s[live], rtol=2e-6)


def test_rescore_rejects_bad_inputs(rng):
    si, terms, _ = segment_case("mixed_widths", rng)
    s1_eff, _ = s1_eff_of(si, rng)
    cand, t_lo, t_hi = rescore_case(si, rng, terms)
    args = port_tensors(si, s1_eff)
    c, lo, hi = (torch.from_numpy(x) for x in (cand, t_lo, t_hi))
    with pytest.raises(TypeError, match="cand"):
        stream_rescore.stream_rescore(*args, c.long(), lo, hi, si.n_docs)
    with pytest.raises(ValueError, match="t_lo"):
        stream_rescore.stream_rescore(*args, c, lo[:1], hi[:1], si.n_docs)


def rescore_variant(si, rng, cand, t_lo, t_hi, variant):
    """A MaxScore phase 2 case bent to one edge: (cand, t_lo, t_hi, k)."""
    cand, t_lo, t_hi = cand.copy(), t_lo.copy(), t_hi.copy()
    k = 10
    if variant == "k_above_c":
        k = cand.shape[1] + 7
    elif variant == "k_equals_c":
        k = cand.shape[1]
    elif variant == "all_pad_rows":
        cand[::3] = si.n_docs
    elif variant == "empty_spans":
        t_hi[:, 0] = t_lo[:, 0]  # every query's first term has no window
        t_hi[1] = t_lo[1]  # and one query none at all
    elif variant == "unsorted":
        for row in cand:
            rng.shuffle(row)
    return cand, t_lo, t_hi, k


@pytest.mark.parametrize(
    "variant", ["k_above_c", "k_equals_c", "all_pad_rows", "empty_spans", "unsorted"]
)
def test_rescore_topk_edges_equal_reference(rng, variant):
    # rescore_topk (one S5 launch on the card: scores and selection) against
    # the reference's _stream_rescore: ids equal, -inf slots with id 0 and
    # the pads past C included; scores within rtol 2e-6.
    si, terms, dead_frac = segment_case("mixed_widths", rng)
    terms = [t for t in terms if t]
    s1_eff, _ = s1_eff_of(si, rng, dead_frac)
    cand, t_lo, t_hi, k = rescore_variant(si, rng, *rescore_case(si, rng, terms), variant)
    bs_steps = int(np.max(t_hi - t_lo, initial=1)).bit_length() + 1
    r_s, r_i = _stream_rescore(
        *ref_tables(si, s1_eff), jnp.asarray(cand), jnp.asarray(t_lo),
        jnp.asarray(t_hi), k=k, n_docs=si.n_docs, bs_steps=bs_steps,
    )
    s, i = stream_rescore.rescore_topk(
        *port_tensors(si, s1_eff), torch.from_numpy(cand),
        torch.from_numpy(t_lo), torch.from_numpy(t_hi), k, si.n_docs,
    )
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    assert s.shape == i.shape == (len(terms), k)
    np.testing.assert_array_equal(i.numpy(), r_i)
    np.testing.assert_array_equal(np.isfinite(s.numpy()), np.isfinite(r_s))
    live = np.isfinite(r_s)
    np.testing.assert_allclose(s.numpy()[live], r_s[live], rtol=2e-6)
    assert (i.numpy()[~live] == 0).all()
    if variant == "all_pad_rows":
        assert not live[::3].any()
    if variant == "empty_spans":
        assert not live[1].any()
    if variant in ("k_above_c", "k_equals_c", "unsorted"):
        assert live.any(axis=1).all()


def test_rescore_keys_leave_shared_memory_past_the_stated_limit(monkeypatch):
    # The wrapper's choice: a query's keys and their sort room stay in the
    # kernel's shared memory while select_room(C, k) <= SMEM_KEYS (208 KB at
    # 8 B a key), else the launch gets a [Q, select_room] int64 scratch row.
    # The launch itself is a stand-in that records what it was handed.
    import contextlib
    import types

    from vectorchord_bm25_tpu_torch.ops import _build

    assert stream_rescore.SMEM_KEYS == 26624
    assert stream_rescore.select_room(512, 10) == 512 + 16
    assert stream_rescore.select_room(16384, 10) == 16384 + 16
    assert stream_rescore.select_room(16384, 16384) == 16384
    assert stream_rescore.select_room(16384, 20000) == 16384
    assert stream_rescore.select_room(100, 1) == 101
    assert stream_rescore.select_room(0, 10) == 0
    assert stream_rescore.select_room(26624 - 16, 16) == 26624
    assert stream_rescore.select_room(26624 - 15, 16) == 26625

    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        bm25_stream_rescore_topk=launch))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0)
    )
    tabs = [torch.zeros(2, dtype=torch.int32) for _ in range(6)]
    t_lo = torch.zeros((3, 2), dtype=torch.int32)
    for c, k, scratch in ((16384, 10, False), (16384, 16384, False),
                          (26624 - 16, 16, False), (26624 - 15, 16, True),
                          (40000, 10, True)):
        cand = torch.zeros((3, c), dtype=torch.int32)
        scores, out_s, out_i = stream_rescore._launch(*tabs, cand, t_lo, t_lo, k, 5)
        args = seen.pop()
        assert scores is None and out_s.shape == out_i.shape == (3, k)
        assert (args[12] is not None) == scratch, (c, k)
        assert args[13:18] == (3, c, 2, 5, k)
    # The scores-only entry: [Q, C] scores, no selection and no scratch.
    scores, out_s, out_i = stream_rescore._launch(
        *tabs, torch.zeros((3, 40000), dtype=torch.int32), t_lo, t_lo, 0, 5
    )
    args = seen.pop()
    assert scores.shape == (3, 40000) and out_s is None and out_i is None
    assert args[9] is not None and args[10:13] == (None, None, None)


# --- replays of tests/test_stream.py on the port


def engines(seg, strategy, **kw):
    si = kw.pop("stream", None) or build_stream_index(seg)
    ref = RefEngine(seg, stream=si, strategy=strategy, **kw)
    port = StreamEngine(seg, stream=si, strategy=strategy, device="cpu", **kw)
    return ref, port


def assert_same(ref, port, queries, k, **kw):
    """Port search == reference search: ids and payloads equal, scores
    bit-equal unless MaxScore's rescore decided them (rtol 2e-6), and the
    same last_ms_stats."""
    s1, i1, p1 = ref.search(queries, k, **kw)
    s2, i2, p2 = port.search(queries, k, **kw)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(p2, p1)
    if ref.last_ms_stats is None:
        assert np.array_equal(s2, s1)
    else:
        np.testing.assert_array_equal(np.isfinite(s2), np.isfinite(s1))
        f = np.isfinite(s1)
        np.testing.assert_allclose(s2[f], s1[f], rtol=2e-6)
    assert port.last_ms_stats == ref.last_ms_stats
    return s2, i2


@pytest.mark.parametrize("strategy", ["dense", "sparse", "maxscore"])
def test_vs_oracle(rng, strategy):
    seg = random_segment(rng, 3000, 80, 30000, tf_hi=5)
    ref, port = engines(seg, strategy)
    queries = [
        Query.from_int_ids(rng.integers(0, 90, size=4).tolist())
        for _ in range(32)
    ]
    scores, ids = assert_same(ref, port, queries, 10)
    for qi, q in enumerate(queries):
        e_scores, e_ids = oracle_topk(seg, q, 10, dtype=np.float32)
        assert np.array_equal(ids[qi][ids[qi] >= 0], e_ids), qi
        np.testing.assert_allclose(scores[qi][: e_ids.size], e_scores, rtol=2e-6)


def _rand_queries(rng, n, vocab, lo=1, hi=7):
    return [
        Query.from_int_ids(rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist())
        for _ in range(n)
    ]


def test_maxscore_pruned_with_mutation_surface(rng):
    seg = random_segment(rng, 4000, 100, 900, tf_hi=8)
    si = build_stream_index(seg)
    ref_ms, ms = engines(seg, "maxscore", stream=si)
    ref_ex, ex = engines(seg, "sparse", stream=si)
    queries = _rand_queries(rng, 48, 900)
    for k in (1, 10, 100):
        _, i_m = assert_same(ref_ms, ms, queries, k)
        _, i_e = assert_same(ref_ex, ex, queries, k)
        assert np.array_equal(i_m, i_e), k
    deleted = rng.random(4000) < 0.5
    for e in (ref_ms, ms, ref_ex, ex):
        e.set_deleted(deleted)
    fmask = (rng.random(4000) < 0.5).astype(np.float32)
    _, i_m = assert_same(ref_ms, ms, queries, 10, filter_mask=fmask)
    _, i_e = assert_same(ref_ex, ex, queries, 10, filter_mask=fmask)
    assert np.array_equal(i_m, i_e)


def _zipf_segment(n, vocab, avg_len):
    from bench import synth_corpus_postings

    keys, doc_ids, tfs, _ = synth_corpus_postings(n, vocab, avg_len)
    return build_sealed_segment_from_postings(keys, doc_ids, tfs, n, doc_grouped=True)


def test_maxscore_tiered_certification_on_common_term_queries(rng):
    seg = _zipf_segment(65536, 20000, 60)
    si = build_stream_index(seg)
    queries = [
        Query.from_int_ids(
            np.unique(
                np.concatenate(
                    [
                        rng.integers(0, 16, size=1),
                        rng.integers(16, 200, size=1),
                        rng.integers(200, 20000, size=2),
                    ]
                )
            ).tolist()
        )
        for _ in range(32)
    ]
    ref_ms, ms = engines(seg, "maxscore", stream=si)
    ref_ex, ex = engines(seg, "sparse", stream=si)
    _, i_m = assert_same(ref_ms, ms, queries, 10)
    _, i_e = assert_same(ref_ex, ex, queries, 10)
    assert np.array_equal(i_m, i_e)
    st = ms.last_ms_stats
    assert st["fallback_queries"] <= 2, st
    assert st["tiers"][0]["windows_phase1"] < 0.3 * st["tiers"][0]["windows_total"]
    _, i_m = assert_same(ref_ms, ms, queries, 1000)
    _, i_e = assert_same(ref_ex, ex, queries, 1000)
    assert np.array_equal(i_m, i_e) and ms.last_ms_stats is not None


def test_auto_routes_per_query_at_scale(rng, monkeypatch):
    seg = _zipf_segment(32768, 10000, 50)
    si = build_stream_index(seg)
    queries = [
        Query.from_int_ids(
            np.unique(
                np.concatenate(
                    [rng.integers(0, 12, size=2), rng.integers(200, 10000, size=2)]
                )
            ).tolist()
        )
        for _ in range(12)
    ] + [Query.from_int_ids(rng.integers(200, 10000, size=4).tolist()) for _ in range(12)]
    # The port has its own copy of the reference's class attributes: set
    # each knob on both classes.
    def knob(name, value):
        for cls in (RefEngine, StreamEngine):
            monkeypatch.setattr(cls, name, value)

    knob("SPARSE_MIN_DOCS", 1000)
    ref_ex, ex = engines(seg, "sparse", stream=si)
    _, i_e = assert_same(ref_ex, ex, queries, 10)
    ref_a, auto = engines(seg, "auto", stream=si)
    _, i_a = assert_same(ref_a, auto, queries, 10)
    assert np.array_equal(i_a, i_e)
    st = auto.last_ms_stats
    assert st["batch_queries"] == len(queries) and 0 <= st["routed_queries"] <= len(queries)
    for frac, min_w, routed in ((1.0, 0, len(queries)), (-1.0, 256, 0)):
        knob("MS_ROUTE_FRAC", frac)
        knob("MS_ROUTE_MIN_WINDOWS", min_w)
        ref_a, auto = engines(seg, "auto", stream=si)
        _, i_a = assert_same(ref_a, auto, queries, 10)
        assert np.array_equal(i_a, i_e)
        assert auto.last_ms_stats["routed_queries"] == routed
    knob("MS_ROUTE_FRAC", 0.35)
    # k above MS_MAX_K and k just above MS_ROUTE_MAX_K: exhaustive, no stats.
    for k in (1500, StreamEngine.MS_ROUTE_MAX_K + 1):
        ref_a, auto = engines(seg, "auto", stream=si)
        _, i_a = assert_same(ref_a, auto, queries, k)
        assert auto.last_ms_stats is None
        _, i_e = assert_same(ref_ex, ex, queries, k)
        assert np.array_equal(i_a, i_e)


def test_maxscore_k_above_pool_falls_back(rng):
    seg = random_segment(rng, 2000, 40, 200, tf_hi=3)
    si = build_stream_index(seg)
    ref_ms, ms = engines(seg, "maxscore", stream=si)
    ref_ex, ex = engines(seg, "sparse", stream=si)
    queries = [Query.from_int_ids(rng.integers(0, 200, size=3).tolist()) for _ in range(8)]
    for k in (300, 1000, 2000):
        _, i_m = assert_same(ref_ms, ms, queries, k)
        _, i_e = assert_same(ref_ex, ex, queries, k)
        assert np.array_equal(i_m, i_e), k
        assert (ms.last_ms_stats is not None) == (k <= StreamEngine.MS_MAX_K), k


@pytest.mark.parametrize("strategy", ["sparse", "maxscore"])
def test_memory_report_equals_reference(rng, strategy):
    seg = random_segment(rng, 3000, 80, 30000, tf_hi=400)
    ref, port = engines(seg, strategy)
    port.search(_rand_queries(rng, 4, 80), 10)
    assert port.memory_report() == ref.memory_report()
    si = port.stream
    assert port.memory_report()["total"] == (
        si.words.nbytes + 4 * (si.n_docs + 1) + 14 * (si.n_windows + 1)
    )
