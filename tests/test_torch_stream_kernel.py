"""The port's stream kernels' plain versions vs the reference's jnp code.

``unpack_and_score_plain`` against M1 ``_unpack_and_score``,
``stream_dense_accumulate_plain`` against ``_stream_dense``'s accumulator
and ``dense_topk_plain`` against ``ops/topk.py::dense_topk``, all on the
CPU as the reference's own tests run them.  Both sides compute each
posting with the same f32 expression and add in the same order, so
scores must be bit-equal (``np.array_equal``) and ids equal wherever the
score is finite.
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
from vectorchord_bm25_tpu.ops.topk import dense_topk as ref_dense_topk  # noqa: E402
from vectorchord_bm25_tpu.search.stream import (  # noqa: E402
    _active_widths,
    _stream_dense,
    _unpack_and_score,
)
from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk  # noqa: E402

from test_topk import N_HIER  # noqa: E402

torch.set_num_threads(2)


def width_segment(rng, tf_hi, n_docs=70_000):
    """A segment whose windows cover every doc width class: term 0 is in
    every doc (2-bit gaps), terms 1-3 step about 6, 100 and 1,000 docs
    (4, 8 and 16 bits), terms 4-39 are random; tfs in [1, tf_hi]."""
    toks, docs = [], []
    for tid, step in enumerate((1, 6, 100, 1000)):
        d = np.arange(int(rng.integers(0, step)), n_docs, step)
        toks.append(np.full(d.size, tid))
        docs.append(d)
    for tid in range(4, 40):
        d = np.unique(rng.integers(0, n_docs, size=int(rng.integers(1, 3000))))
        toks.append(np.full(d.size, tid))
        docs.append(d)
    tok = np.concatenate(toks)
    doc = np.concatenate(docs)
    tf = rng.integers(1, tf_hi + 1, size=tok.size)
    return posting_segment(tok, doc, tf, n_docs)


def posting_segment(tok, doc, tf, n_docs):
    keys_u8 = np.zeros((tok.size, 16), dtype=np.uint8)
    keys_u8[:, :4] = tok.astype(">u4").view(np.uint8).reshape(-1, 4)
    keys = keys_u8.reshape(-1).view("S16")
    order = np.lexsort((doc, tok))
    return build_sealed_segment_from_postings(
        keys[order], doc[order], tf[order], n_docs, presorted=True
    )


def big_gap_segment(rng):
    """tests/test_stream.py::test_big_gaps_and_tf16's corpus: 16-bit gaps
    with re-anchoring splits and tf > 255 (16-bit tf words)."""
    n_docs = 200_000
    doc_a = np.arange(0, n_docs, 37_111, dtype=np.int64)
    doc_b = np.arange(0, n_docs, 301, dtype=np.int64)
    doc_c = np.arange(5_000, 5_600, dtype=np.int64)
    tok = np.concatenate(
        [np.zeros_like(doc_a), np.ones_like(doc_b), np.full_like(doc_c, 2)]
    )
    doc = np.concatenate([doc_a, doc_b, doc_c])
    tf = np.concatenate(
        [np.full_like(doc_a, 300), np.ones_like(doc_b), rng.integers(1, 5, doc_c.size)]
    )
    return posting_segment(tok, doc, tf, n_docs)


def tables(si):
    """The engine's [W+1] window tables (entry W: the pad window) as numpy,
    in the reference's dtypes."""
    pad_off = si.words.size - 64
    return (
        np.append(si.w_off4, pad_off).astype(np.int32),
        np.append(si.w_base, 0).astype(np.int32),
        np.append(si.w_meta16(), 0).astype(np.uint16),
        np.append(si.w_s0, 0.0).astype(np.float32),
    )


def s1_eff_of(si, rng, dead_frac=0.2):
    """s1[fieldnorm] per doc with +inf at random dead (deleted or filtered)
    docs and the pad slot; returns (s1_eff, dead mask)."""
    s1 = si.s1_table[si.doc_fn & 0xFF].astype(np.float32)
    dead = np.append(rng.random(si.n_docs) < dead_frac, True)
    return np.where(dead, np.inf, s1).astype(np.float32), dead


def port_unpack(si, s1_eff, off, base, meta, s0):
    return stream_kernel.unpack_and_score_plain(
        torch.from_numpy(si.words.view(np.int32)),
        torch.from_numpy(s1_eff),
        torch.from_numpy(off),
        torch.from_numpy(base),
        torch.from_numpy(meta.view(np.int16)),
        torch.from_numpy(s0),
        si.n_docs,
    )


@pytest.mark.parametrize("tf_hi", [1, 3, 15, 255, 400])
def test_unpack_and_score_every_width(rng, tf_hi):
    si = build_stream_index(width_segment(rng, tf_hi))
    assert set(np.unique(si.w_dbits)) == {2, 4, 8, 16}
    want_tf = {1: {0}, 3: {2}, 15: {4}, 255: {8}, 400: {16}}[tf_hi]
    assert want_tf <= set(np.unique(si.w_tfbits))
    off, base, meta, s0 = tables(si)
    s1_eff, dead = s1_eff_of(si, rng)
    # Every window plus pad windows, as a [Q, P] gather.
    w = np.append(np.arange(si.n_windows), [si.n_windows] * 3)
    w = np.append(w, np.full((-w.size) % 8, si.n_windows)).reshape(8, -1)
    r_doc, r_sc = _unpack_and_score(
        jnp.asarray(si.words), jnp.asarray(s1_eff), jnp.asarray(off[w]),
        jnp.asarray(base[w]), jnp.asarray(meta[w]), jnp.asarray(s0[w]),
        si.n_docs,
    )
    doc, sc = port_unpack(si, s1_eff, off[w], base[w], meta[w], s0[w])
    np.testing.assert_array_equal(doc.numpy(), np.asarray(r_doc))
    assert np.array_equal(sc.numpy(), np.asarray(r_sc))
    # Pad lanes and dead docs score exactly 0.0; live docs score > 0.
    d, s = doc.numpy(), sc.numpy()
    assert np.all(s[d == si.n_docs] == 0.0)
    assert np.all(s[dead[d]] == 0.0)
    assert np.all(s[~dead[d]] > 0.0)
    assert np.all(d[w == si.n_windows] == si.n_docs)  # pad windows


def test_unpack_and_score_big_gaps_and_tf16(rng):
    seg = big_gap_segment(rng)
    si = build_stream_index(seg)
    assert si.tf_width == 2 and 16 in set(np.unique(si.w_tfbits))
    off, base, meta, s0 = tables(si)
    s1_eff, _ = s1_eff_of(si, rng, dead_frac=0.0)
    w = np.arange(si.n_windows + 1)[None, :]
    r_doc, r_sc = _unpack_and_score(
        jnp.asarray(si.words), jnp.asarray(s1_eff), jnp.asarray(off[w]),
        jnp.asarray(base[w]), jnp.asarray(meta[w]), jnp.asarray(s0[w]),
        si.n_docs,
    )
    doc, sc = port_unpack(si, s1_eff, off[w], base[w], meta[w], s0[w])
    np.testing.assert_array_equal(doc.numpy(), np.asarray(r_doc))
    assert np.array_equal(sc.numpy(), np.asarray(r_sc))
    # The decoded postings are the sealed ones (lossless).
    d = doc.numpy()[0]
    decoded = np.sort(d[d < si.n_docs])
    assert np.array_equal(decoded, np.sort(seg.postings()[1]))


def dispatch(si, rng, n_q=6):
    """A dispatch as the engine builds one: random queries of 1-4 terms
    (a repeated term counts twice), their windows term-major in query
    order, padded to a multiple of 128 with pad windows."""
    wsrc, wq, word_ord = [], [], []
    tws = si.token_w_start
    for q in range(n_q):
        terms = rng.integers(0, si.n_tokens, size=int(rng.integers(1, 5)))
        if q == 0:
            terms = np.array([1, 1, 2])
        for o, tid in enumerate(terms):
            span = np.arange(tws[tid], tws[tid + 1])
            wsrc.append(span)
            wq.append(np.full(span.size, q))
            word_ord.append(np.full(span.size, o))
    wsrc, wq, word_ord = (np.concatenate(x) for x in (wsrc, wq, word_ord))
    pad = (-wsrc.size) % 128 or 128
    wsrc = np.append(wsrc, np.full(pad, si.n_windows)).astype(np.int32)
    wq = np.append(wq, np.zeros(pad)).astype(np.int32)
    word_ord = np.append(word_ord, np.zeros(pad)).astype(np.int64)
    return wsrc, wq, word_ord, 8


def port_lists(si, wsrc, wq, word_ord, n_q):
    """A dispatch in the port's form: (wsrc, q_start [n_q + 1], w_ord) int32
    tensors, each query's span of the windows and the trailing pad windows
    outside every span with ordinal -1 (the rows past the queries own
    none)."""
    t = int((wsrc < si.n_windows).sum())
    q_start = np.searchsorted(wq[:t], np.arange(n_q + 1)).astype(np.int32)
    w_ord = np.where(np.arange(wsrc.size) < t, word_ord, -1).astype(np.int32)
    return torch.from_numpy(wsrc), torch.from_numpy(q_start), torch.from_numpy(w_ord)


def port_tensors(si, s1_eff):
    off, base, meta, s0 = tables(si)
    return (
        torch.from_numpy(si.words.view(np.int32)),
        torch.from_numpy(s1_eff),
        torch.from_numpy(off),
        torch.from_numpy(base),
        torch.from_numpy(meta.view(np.int16)),
        torch.from_numpy(s0),
    )


@pytest.mark.parametrize("tf_hi", [1, 15, 400])
def test_dense_accumulate_equals_reference_accumulator(rng, tf_hi):
    si = build_stream_index(width_segment(rng, tf_hi, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng)
    wsrc, wq, word_ord, n_q = dispatch(si, rng)
    off, base, meta, s0 = tables(si)
    # The reference's accumulator: _stream_dense's lines before dense_topk.
    r_doc, r_sc = _unpack_and_score(
        jnp.asarray(si.words), jnp.asarray(s1_eff),
        jnp.asarray(off[wsrc])[:, None], jnp.asarray(base[wsrc])[:, None],
        jnp.asarray(meta[wsrc])[:, None], jnp.asarray(s0[wsrc])[:, None],
        si.n_docs,
    )
    n1 = si.n_docs + 1
    idx = jnp.asarray(wq)[:, None] * n1 + r_doc.reshape(-1, 128)
    ref = jnp.zeros(n_q * n1, jnp.float32).at[idx.reshape(-1)].add(r_sc.reshape(-1))
    ref = np.asarray(ref).reshape(n_q, n1)
    acc = stream_kernel.stream_dense_accumulate(
        *port_tensors(si, s1_eff), *port_lists(si, wsrc, wq, word_ord, n_q),
        n_q, si.n_docs,
    )
    assert acc.shape == (n_q, n1) and acc.stride(0) % 4 == 0
    assert np.array_equal(acc.numpy(), ref)
    assert (ref > 0).sum() > 100


def test_lockstep_with_reference_stream_dense(rng):
    # The same (wsrc, wq) through the reference's _stream_dense and through
    # the port's accumulate + dense_topk.
    si = build_stream_index(width_segment(rng, 15, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng)
    wsrc, wq, word_ord, n_q = dispatch(si, rng, n_q=8)
    off, base, meta, s0 = tables(si)
    dw, tw = _active_widths(si.w_meta[wsrc[wsrc < si.n_windows]])
    r_s, r_i = _stream_dense(
        jnp.asarray(si.words), jnp.asarray(s1_eff), jnp.asarray(off),
        jnp.asarray(base), jnp.asarray(meta), jnp.asarray(s0),
        jnp.asarray(wsrc), jnp.asarray(wq), k=16, n_docs=si.n_docs, n_q=n_q,
        dwidths=dw, twidths=tw,
    )
    acc = stream_kernel.stream_dense_accumulate(
        *port_tensors(si, s1_eff), *port_lists(si, wsrc, wq, word_ord, n_q),
        n_q, si.n_docs,
    )
    s, i = topk.dense_topk(acc, 16, si.n_docs)
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    assert np.array_equal(s.numpy(), r_s)
    live = np.isfinite(r_s)
    assert live.sum() > 16
    np.testing.assert_array_equal(i.numpy()[live], r_i[live])


def test_ordinal_order_is_what_makes_it_exact(rng):
    # Windows handed over in any order inside their query's span give the
    # same accumulator: the ordinals, not the window order, fix the order
    # of the adds.
    si = build_stream_index(width_segment(rng, 3, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng)
    wsrc, wq, word_ord, n_q = dispatch(si, rng)
    args = port_tensors(si, s1_eff)
    ws, q_start, w_ord = port_lists(si, wsrc, wq, word_ord, n_q)
    a = stream_kernel.stream_dense_accumulate(*args, ws, q_start, w_ord, n_q, si.n_docs)
    qs = q_start.numpy()
    perm = np.concatenate(
        [lo + rng.permutation(hi - lo) for lo, hi in zip(qs[:-1], qs[1:])]
        + [np.arange(qs[-1], wsrc.size)]
    )
    b = stream_kernel.stream_dense_accumulate(
        *args, ws[perm], q_start, w_ord[perm], n_q, si.n_docs
    )
    assert torch.equal(a, b)
    assert not stream_kernel.stream_spans_in_layout(
        ws[perm], q_start, w_ord[perm], args[3]
    ).all()


def test_accumulate_rejects_bad_inputs(rng):
    si = build_stream_index(width_segment(rng, 3, n_docs=5_000))
    s1_eff, _ = s1_eff_of(si, rng)
    wsrc, wq, word_ord, n_q = dispatch(si, rng)
    args = list(port_tensors(si, s1_eff))
    ws, qs, wo = port_lists(si, wsrc, wq, word_ord, n_q)
    with pytest.raises(TypeError, match="wsrc"):
        stream_kernel.stream_dense_accumulate(
            *args, ws.long(), qs, wo, n_q, si.n_docs
        )
    bad = list(args)
    bad[4] = bad[4].to(torch.int32)
    with pytest.raises(TypeError, match="w_meta"):
        stream_kernel.stream_dense_accumulate(
            *bad, ws, qs, wo, n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="contiguous"):
        stream_kernel.stream_dense_accumulate(
            *args, torch.stack([ws, ws], 1)[:, 0], qs, wo, n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="w_ord"):
        stream_kernel.stream_dense_accumulate(
            *args, ws, qs, wo[:-1], n_q, si.n_docs
        )
    with pytest.raises(TypeError, match="w_ord"):
        stream_kernel.stream_dense_accumulate(
            *args, ws, qs, wo.long(), n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="q_start"):
        stream_kernel.stream_dense_accumulate(
            *args, ws, qs[:-1], wo, n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="s1_eff"):
        stream_kernel.stream_dense_accumulate(
            *args, ws, qs, wo, n_q, si.n_docs + 1
        )


def _topk_check(acc: np.ndarray, k: int, n_docs: int):
    r_s, r_i = ref_dense_topk(jnp.asarray(acc), k, n_docs)
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    s, i = topk.dense_topk(torch.from_numpy(acc), k, n_docs)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert np.array_equal(s.numpy(), r_s)
    live = np.isfinite(r_s)
    np.testing.assert_array_equal(i.numpy()[live], r_i[live])
    # The strided, 16-B-aligned layout the engine hands over: same result.
    strided = topk.new_accumulator(acc.shape[0], acc.shape[1] - 1, "cpu")
    strided.copy_(torch.from_numpy(acc))
    s2, i2 = topk.dense_topk(strided, k, n_docs)
    assert torch.equal(s2, s) and torch.equal(i2, i)


def _ties():
    rng = np.random.default_rng(0)
    acc = np.zeros((4, N_HIER + 1), dtype=np.float32)
    acc[:, :N_HIER] = rng.choice(
        np.array([0.0, 0.0, 1.0, 2.0, 3.0], dtype=np.float32), size=(4, N_HIER)
    )
    return acc, 10, N_HIER


def _tail_wins():
    acc = np.zeros((2, N_HIER + 1), dtype=np.float32)
    acc[:, :N_HIER] = 0.5
    acc[0, N_HIER - 3 :] = 0.0
    acc[0, N_HIER - 5] = 9.0
    acc[1, N_HIER - 1] = 7.5
    return acc, 4, N_HIER


def _fewer_than_k():
    acc = np.zeros((3, N_HIER + 1), dtype=np.float32)
    acc[0, 11] = 2.0
    acc[1, 5] = 1.0
    acc[1, N_HIER - 1] = 3.0
    return acc, 8, N_HIER


def _sentinel():
    acc = np.zeros((1, N_HIER + 1), dtype=np.float32)
    acc[0, N_HIER] = 100.0
    acc[0, 7] = 1.0
    return acc, 3, N_HIER


def _small_corpus():
    rng = np.random.default_rng(1)
    n = 5000
    acc = np.zeros((3, n + 1), dtype=np.float32)
    acc[:, :n] = rng.choice(np.array([0.0, 1.0, 2.0], dtype=np.float32), size=(3, n))
    return acc, 7, n


def _random_dense():
    rng = np.random.default_rng(2)
    acc = np.zeros((2, N_HIER + 1), dtype=np.float32)
    acc[:, :N_HIER] = rng.random((2, N_HIER), dtype=np.float32) - 0.2
    return acc, 16, N_HIER


def _exactly_2_17():
    # n_docs = 2^17: the first size that takes the hierarchy, with one
    # ragged tail column (the pad) and ties across blocks.
    rng = np.random.default_rng(3)
    n = 1 << 17
    acc = np.zeros((3, n + 1), dtype=np.float32)
    acc[:, :n] = rng.choice(
        np.array([0.0, 0.25, 0.5, 4.0], dtype=np.float32), size=(3, n),
        p=[0.9, 0.05, 0.0499, 0.0001],
    )
    return acc, 16, n


# tests/test_topk.py's six cases, plus the 2^17-doc case.
TOPK_CASES = {
    "ties": _ties,
    "tail_block_wins": _tail_wins,
    "fewer_than_k_positive": _fewer_than_k,
    "sentinel_column_excluded": _sentinel,
    "small_corpus": _small_corpus,
    "random_dense": _random_dense,
    "exactly_2_17_docs": _exactly_2_17,
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_dense_topk_equals_reference(case):
    acc, k, n_docs = TOPK_CASES[case]()
    assert topk._hierarchical(acc.shape[1], k, n_docs, 1024) == (
        case != "small_corpus"
    )
    _topk_check(acc, k, n_docs)


def test_dense_topk_rejects_bad_inputs():
    acc = torch.zeros((2, 10), dtype=torch.float64)
    with pytest.raises(TypeError):
        topk.dense_topk(acc, 2, 9)
    with pytest.raises(ValueError):
        topk.dense_topk(torch.zeros(10), 2, 9)
    with pytest.raises(ValueError):
        topk.dense_topk(torch.zeros((2, 10)), 2, 11)


def _design_pads(flat):
    # Rows with 0 to k - 1 positive docs: the pads' ids are the lowest doc
    # ids among the positions the plain version gathers (the chosen blocks,
    # all-nonpositive ones by lowest block id, then the tail).
    rng = np.random.default_rng(21)
    n = 5000 if flat else N_HIER
    acc = np.zeros((6, n + 1), dtype=np.float32)
    for row in range(1, 6):
        docs = rng.choice(n, size=2 * row, replace=False)
        acc[row, docs] = rng.random(docs.size, dtype=np.float32) + 0.5
    acc[5, : n : 3] = -1.0  # non-positive lanes are pads too
    return acc, 16, n


def _design_block_ties():
    # More blocks than k share the k-th block maximum, and docs inside the
    # chosen blocks tie with it: ties enter by doc id.
    rng = np.random.default_rng(22)
    acc = np.zeros((3, N_HIER + 1), dtype=np.float32)
    acc[:, :N_HIER] = rng.choice(
        np.array([0.0, 0.5, 1.0], dtype=np.float32), size=(3, N_HIER), p=[0.9, 0.09, 0.01]
    )
    blocks = rng.choice(N_HIER // 1024, size=(3, 24), replace=False)
    for row in range(3):
        for b in blocks[row]:
            acc[row, b * 1024 + rng.choice(1024, size=3, replace=False)] = 2.0
    return acc, 16, N_HIER


def _design_nan_zero(flat):
    rng = np.random.default_rng(23)
    n = 6000 if flat else N_HIER
    acc = np.zeros((3, n + 1), dtype=np.float32)
    acc[:, :n] = rng.random((3, n), dtype=np.float32) - 0.6
    acc[:, rng.choice(n, size=n // 5, replace=False)] = np.nan
    acc[:, rng.choice(n, size=n // 5, replace=False)] = -0.0
    acc[2, :n] = np.where(acc[2, :n] > 0, np.nan, acc[2, :n])  # no positive left
    acc[2, 17] = 3.0
    return acc, 16, n


def _design_tail():
    # A ragged tail of 700 columns past n_docs (as the range sweep's
    # accumulator has) and a positive value past n_docs that must not win.
    rng = np.random.default_rng(24)
    m, n = N_HIER + 700, N_HIER
    acc = np.zeros((3, m), dtype=np.float32)
    acc[:, :n] = np.where(rng.random((3, n)) < 0.001, rng.random((3, n), dtype=np.float32), 0)
    acc[:, n - 300 : n] = rng.random((3, 300), dtype=np.float32) * 4
    acc[1, n:] = 50.0
    acc[2, :n] = 0.0
    return acc, 16, n


def _design_wide_k(flat):
    rng = np.random.default_rng(25)
    n = 9000 if flat else N_HIER
    acc = np.zeros((2, n + 1), dtype=np.float32)
    acc[:, :n] = np.where(rng.random((2, n)) < 0.05, rng.random((2, n), dtype=np.float32), 0)
    return acc, (100 if flat else 40), n


# The cases the kernels' design must keep (csrc/dense_topk.cu): pad ids,
# ties at the k-th block maximum, NaN and -0.0 lanes, a tail past n_docs,
# k > 32, in both branches.
DESIGN_CASES = {
    "pads_hierarchical": lambda: _design_pads(False),
    "pads_flat": lambda: _design_pads(True),
    "ties_at_kth_block_max": _design_block_ties,
    "nan_and_negative_zero_hierarchical": lambda: _design_nan_zero(False),
    "nan_and_negative_zero_flat": lambda: _design_nan_zero(True),
    "tail_past_n_docs": _design_tail,
    "k_above_32_hierarchical": lambda: _design_wide_k(False),
    "k_above_32_flat": lambda: _design_wide_k(True),
}


@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_dense_topk_design_cases_equal_reference(case):
    acc, k, n_docs = DESIGN_CASES[case]()
    assert topk._hierarchical(acc.shape[1], k, n_docs, 1024) == ("flat" not in case)
    _topk_check(acc, k, n_docs)
    # Every id, the pads' included, equals the reference's.
    r_i = np.asarray(ref_dense_topk(jnp.asarray(acc), k, n_docs)[1])
    s, i = topk.dense_topk_plain(torch.from_numpy(acc), k, n_docs)
    np.testing.assert_array_equal(i.numpy(), r_i)
    assert (~torch.isfinite(s)).any() == ("pads" in case or "nan" in case or case == "tail_past_n_docs")
