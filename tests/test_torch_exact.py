"""The port's exact engine against the reference's, on the CPU.

- Lockstep: the plain versions of E1, E2 and E3 (``ops/exact_kernel.py``),
  followed by the port's top-k, against the reference's jitted
  ``_score_and_topk``, ``_score_and_topk_sparse`` and
  ``_score_and_topk_compact`` on the same windows, in f32 and bf16, with
  deletes, a filter and a repeated query term.
- Replays of ``tests/test_exact.py``, ``tests/test_sparse_exact.py`` and
  ``tests/test_compact_exact.py`` (with its memory reports) on the port,
  each also held to the reference engine's own output.
- The facade's ``engine="exact"`` cases of ``tests/test_growing_batch.py``
  and ``tests/test_prefilter.py``.

Tolerance: ids equal and scores equal bit for bit, everywhere (every path
adds a doc's terms in ascending term order, as the reference's CPU scatter
does).  ``memory_report()`` dicts are equal.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import (  # noqa: E402
    build_sealed_segment,
    build_sealed_segment_from_postings,
)
from vectorchord_bm25_tpu.search import exact as ref_exact  # noqa: E402
from vectorchord_bm25_tpu.search.blockmax import BlockMaxEngine as RefBlockMax  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document, Query, random_seed  # noqa: E402
from vectorchord_bm25_tpu.utils.memparity import (  # noqa: E402
    memory_parity_report,
    reference_format_bytes,
)
from vectorchord_bm25_tpu.utils.options import IndexOptions, SearchOptions  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import exact_kernel, topk  # noqa: E402
from vectorchord_bm25_tpu_torch.ops.stream_sparse import (  # noqa: E402
    ordinal_offsets,
    sparse_lanes_topk,
)
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.search.exact import ExactEngine, oracle_topk  # noqa: E402
from vectorchord_bm25_tpu_torch.search.hybrid import HybridEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.options import (  # noqa: E402
    IndexOptions as PortIndexOptions,
    SearchOptions as PortSearchOptions,
)

from test_exact import rank_match, scalar_topk  # noqa: E402
from test_sealed import make_docs  # noqa: E402


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


torch.set_num_threads(2)

# The three forms of the engine (E1, E2, E3), as constructor options.
FORMS = {
    "dense": {"strategy": "dense"},
    "sparse": {"strategy": "sparse"},
    "compact": {"compact": True},
}


def both(seg, **opts):
    """(reference engine, port engine on the CPU) over one segment."""
    return ref_exact.ExactEngine(seg, **opts), ExactEngine(
        segment_from_reference(seg), device="cpu", **opts
    )


def assert_same(got, want):
    """(scores, ids, payloads) equal bit for bit."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def repeated_query(ids):
    """A query whose first term occurs twice.  ``Query`` merges or rejects
    repeated keys, but the engines take anything with ``keys``: given such
    a query, both packages score both occurrences, in window order."""
    keys = Query.from_int_ids(ids).keys
    return types.SimpleNamespace(keys=np.concatenate([keys[:1], keys]))


def _queries(rng, n, vocab, terms=(1, 6)):
    return [
        Query.from_int_ids(rng.integers(0, vocab, size=int(t)).tolist())
        for t in rng.integers(*terms, size=n)
    ]


# --- lockstep: each plain kernel against the reference's jitted function


def _torch(x):
    """A jnp array as a torch tensor of the same type (bf16 by its bits)."""
    if x.dtype == jnp.bfloat16:
        bits = np.asarray(x.view(jnp.int16))
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def lockstep_case():
    rng = np.random.default_rng(0xE1)
    n_docs, vocab = 900, 25
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    queries = _queries(rng, 24, vocab) + [
        repeated_query([3, 5]),  # a repeated term
        Query.from_int_ids([10**6]),  # an absent one
        Query(keys=np.zeros(0, dtype="S16")),
    ]
    deleted = rng.random(n_docs) < 0.2
    fm = np.ones(n_docs + 1, dtype=np.float32)
    fm[:n_docs] = rng.random(n_docs) < 0.6
    return seg, queries, deleted, fm


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 1024])
def test_lockstep_dense(lockstep_case, impact_dtype, filtered, k):
    seg, queries, deleted, fm = lockstep_case
    ref, port = both(seg, impact_dtype=impact_dtype)
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    wr, wl, wh, wo = port._prepare(*looked_up(port, queries))
    for got, want in zip((wr, wl, wh), ref._prepare(queries)):
        np.testing.assert_array_equal(got, want)
    fm = fm if filtered else np.ones_like(fm)
    kk = min(k, seg.n_docs)
    want_s, want_i = ref_exact._jitted_score_and_topk()(
        ref.dev.post_docid, ref.dev.post_impact, ref.dev.doc_live,
        jnp.asarray(wr), jnp.asarray(wl), jnp.asarray(wh), jnp.asarray(fm),
        k=kk, n_docs=seg.n_docs,
    )
    dev = port.dev
    assert dev.post_impact.dtype == _torch(ref.dev.post_impact).dtype
    assert torch.equal(dev.post_impact, _torch(ref.dev.post_impact))  # bf16: same rounding
    acc = exact_kernel.exact_dense_accumulate_plain(
        dev.post_docid, dev.post_impact, dev.doc_live,
        torch.from_numpy(wr), torch.from_numpy(wl), torch.from_numpy(wh),
        torch.from_numpy(wo), int(wo.max()) + 1, seg.n_docs,
        filter_mask=torch.from_numpy(fm) if filtered else None,
    )
    got_s, got_i = topk.dense_topk(acc, kk, seg.n_docs)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    live = np.isfinite(np.asarray(want_s))
    assert live.any()
    np.testing.assert_array_equal(got_i.numpy()[live], np.asarray(want_i)[live])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 1 << 17])
def test_lockstep_sparse(lockstep_case, impact_dtype, filtered, k):
    seg, queries, deleted, fm = lockstep_case
    ref, port = both(seg, impact_dtype=impact_dtype, strategy="sparse")
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    wr, wl, wh, _, mt = port._prepare(*looked_up(port, queries), with_terms=True)
    assert mt == ref._prepare(queries, with_terms=True)[3] == 5
    fm = fm if filtered else np.ones_like(fm)
    seg_steps = int(mt - 1).bit_length()
    want_s, want_i = ref_exact._jitted_score_and_topk_sparse()(
        ref.dev.post_docid, ref.dev.post_impact, ref.dev.doc_live,
        jnp.asarray(wr), jnp.asarray(wl), jnp.asarray(wh), jnp.asarray(fm),
        k=k, n_docs=seg.n_docs, seg_steps=seg_steps,
    )
    dev = port.dev
    doc, sc = exact_kernel.exact_sparse_gather_plain(
        dev.post_docid, dev.post_impact, dev.doc_live, torch.from_numpy(fm),
        torch.from_numpy(wr), torch.from_numpy(wl), torch.from_numpy(wh),
        seg.n_docs,
    )
    assert doc.shape == sc.shape == (len(queries), wr.shape[1] * 128)
    assert sc.dtype == torch.float32  # the products are f32 also over bf16 rows
    got_s, got_i = sparse_lanes_topk(doc, sc, k, seg.n_docs, seg_steps)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    live = np.isfinite(np.asarray(want_s))
    assert live.any()
    np.testing.assert_array_equal(got_i.numpy()[live], np.asarray(want_i)[live])


EXACT_SEG_CASES = ["as_built", "deleted_filtered", "all_filtered", "bf16"]


@pytest.mark.parametrize("case", EXACT_SEG_CASES)
@pytest.mark.parametrize("k", [10, 512, 2048])
def test_sparse_topk_segments_equal_reference(lockstep_case, case, k):
    # exact_sparse_topk's CPU path given each row's segments (the planning's
    # term ordinals), and the numpy model of SP-exact's decomposition,
    # against _score_and_topk_sparse: scores bit-equal and every id equal,
    # the -inf pads' too.
    from test_torch_stream_sparse import sparse_merge_model

    seg, queries, deleted, fm = lockstep_case
    dtype = "bfloat16" if case == "bf16" else "float32"
    ref, port = both(seg, impact_dtype=dtype, strategy="sparse")
    if case != "as_built":
        ref.set_deleted(deleted)
        port.set_deleted(deleted)
    fm = {
        "as_built": np.ones_like(fm),
        "deleted_filtered": fm,
        "all_filtered": np.append(np.zeros(seg.n_docs, np.float32), 1.0).astype(np.float32),
        "bf16": fm,
    }[case]
    wr, wl, wh, wo, mt = port._prepare(*looked_up(port, queries), with_terms=True)
    seg_steps = int(mt - 1).bit_length()
    want_s, want_i = (
        np.asarray(x)
        for x in ref_exact._jitted_score_and_topk_sparse()(
            ref.dev.post_docid, ref.dev.post_impact, ref.dev.doc_live,
            jnp.asarray(wr), jnp.asarray(wl), jnp.asarray(wh), jnp.asarray(fm),
            k=k, n_docs=seg.n_docs, seg_steps=seg_steps,
        )
    )
    dev = port.dev
    seg_off = ordinal_offsets(wo)
    wins = [torch.from_numpy(x) for x in (wr, wl, wh)]
    got_s, got_i = exact_kernel.exact_sparse_topk(
        dev.post_docid, dev.post_impact, dev.doc_live, torch.from_numpy(fm), *wins,
        k, seg.n_docs, seg_steps, torch.from_numpy(seg_off),
    )
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    doc, sc = exact_kernel.exact_sparse_gather_plain(
        dev.post_docid, dev.post_impact, dev.doc_live, torch.from_numpy(fm), *wins, seg.n_docs
    )
    q, p = wr.shape
    flat = dev.post_docid.numpy().reshape(-1)
    base = np.where(wl < wh, flat[np.minimum(wr.astype(np.int64) * 128 + wl, flat.size - 1)],
                    0x7FFFFFFF)
    m_s, m_i, st = sparse_merge_model(
        doc.numpy().reshape(q, p, 128), sc.numpy().reshape(q, p, 128), base, seg_off, k,
        seg.n_docs, seg_steps,
    )
    np.testing.assert_array_equal(m_s, want_s)
    np.testing.assert_array_equal(m_i, want_i)
    if case == "all_filtered":
        assert not np.isfinite(want_s).any() and st["pad_rows"] == q
    assert (want_i[~np.isfinite(want_s)] > 0).any()  # pads with doc ids in every case


@pytest.mark.parametrize("k", [10, 2048])
def test_sparse_topk_past_a_tile_of_segments(lockstep_case, k):
    # exact_sparse_topk's CPU path on rows of more term occurrences than
    # SP-exact's tile has lanes (2,049 and 2,100 ordinals, with deletes and
    # a filter) against _score_and_topk_sparse: scores and every id equal.
    seg, _, deleted, fm = lockstep_case
    ref, port = both(seg, strategy="sparse")
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    keys = lambda ids, n: np.concatenate([Query.from_int_ids(ids).keys] * n)  # noqa: E731
    queries = [
        types.SimpleNamespace(keys=keys([3], 2049)),
        types.SimpleNamespace(keys=keys([5, 7], 1050)),
        Query.from_int_ids([3, 9]),
    ]
    wr, wl, wh, wo, mt = port._prepare(*looked_up(port, queries), with_terms=True)
    seg_off = ordinal_offsets(wo)
    assert seg_off.shape[1] - 1 == mt == 2100
    seg_steps = int(mt - 1).bit_length()
    want_s, want_i = (
        np.asarray(x)
        for x in ref_exact._jitted_score_and_topk_sparse()(
            ref.dev.post_docid, ref.dev.post_impact, ref.dev.doc_live,
            jnp.asarray(wr), jnp.asarray(wl), jnp.asarray(wh), jnp.asarray(fm),
            k=k, n_docs=seg.n_docs, seg_steps=seg_steps,
        )
    )
    assert np.isfinite(want_s).any()
    dev = port.dev
    got_s, got_i = exact_kernel.exact_sparse_topk(
        dev.post_docid, dev.post_impact, dev.doc_live, torch.from_numpy(fm),
        *(torch.from_numpy(x) for x in (wr, wl, wh)), k, seg.n_docs, seg_steps,
        torch.from_numpy(seg_off),
    )
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 1024])
def test_lockstep_compact(lockstep_case, impact_dtype, filtered, k):
    seg, queries, deleted, fm = lockstep_case
    ref, port = both(seg, impact_dtype=impact_dtype, compact=True)
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    grp_ids, grp_ord = port._prepare_compact(*looked_up(port, queries))
    np.testing.assert_array_equal(grp_ids, ref._prepare_compact(queries))
    fm = fm if filtered else np.ones_like(fm)
    kk = min(k, seg.n_docs)
    rs = ref._ranges.range_size
    want_s, want_i = ref_exact._jitted_score_and_topk_compact()(
        ref.dev_post_impact, ref.dev_post_local, ref.dev_tr_range,
        ref.dev_tr_start, ref.dev.doc_live, jnp.asarray(fm),
        jnp.asarray(grp_ids), k=kk, n_docs=seg.n_docs, range_size=rs,
    )
    assert torch.equal(port.dev_post_impact, _torch(ref.dev_post_impact))
    acc = exact_kernel.exact_compact_accumulate_plain(
        port.dev_post_impact, port.dev_post_local, port.dev_tr_range,
        port.dev_tr_start, torch.from_numpy(grp_ids), torch.from_numpy(grp_ord),
        int(grp_ord.max()) + 1, seg.n_docs, rs,
    )
    acc.mul_(port.dev.doc_live).mul_(torch.from_numpy(fm))
    got_s, got_i = topk.dense_topk(acc, kk, seg.n_docs)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    live = np.isfinite(np.asarray(want_s))
    assert live.any()
    np.testing.assert_array_equal(got_i.numpy()[live], np.asarray(want_i)[live])


def test_term_ordinals(lockstep_case):
    # The one array the port's lists add: each window's (group's) term
    # ordinal inside its query, ascending, -1 on pads; a repeated term gets
    # an ordinal of its own.
    seg, queries, _, _ = lockstep_case
    _, dense = both(seg)
    _, compact = both(seg, compact=True)
    wr, wl, wh, wo = dense._prepare(*looked_up(dense, queries))
    assert ((wo >= 0) == (wh > wl)).all()
    grp_ids, grp_ord = compact._prepare_compact(*looked_up(compact, queries))
    assert ((grp_ord >= 0) == (grp_ids < compact._ranges.tr_range.size)).all()
    for ords in (wo, grp_ord):
        for row, q in zip(ords, queries):
            real = row[row >= 0]
            assert (np.diff(real) >= 0).all()
            n_terms = int((dense.segment.lookup_tokens(q.keys) >= 0).sum())
            assert set(real.tolist()) == set(range(n_terms))
    repeated = len(queries) - 3
    assert set(wo[repeated][wo[repeated] >= 0].tolist()) == {0, 1, 2}


def layout_ok_numpy(grp_ids, grp_ord, tr_range, n_ord, n_docs, rs):
    """E3's layout rule (csrc/exact_compact.cu, L1 and L2), entry by entry:
    (ordinal, clamped range) strictly rises over a row's groups with an
    ordinal in [0, n_ord), which come before every other entry."""
    cap = n_docs // rs + 1
    out = []
    for ids, ords in zip(np.asarray(grp_ids).tolist(), np.asarray(grp_ord).tolist()):
        ok, prev = True, (-1, 0)
        for g, o in zip(ids, ords):
            if not 0 <= o < n_ord:
                prev = None
                continue
            r = int(tr_range[g]) if 0 <= g < len(tr_range) else -1
            cur = (o, min(r, cap) if r >= 0 else -1)
            ok &= prev is not None and prev < cur
            prev = cur
        out.append(ok)
    return np.array(out)


def assert_compact_layout(grp_ids, grp_ord, tr_range, n_docs, rs):
    """What E3 relies on, on a planned group matrix: each row's ordinals in
    non-decreasing runs with every pad (-1) at the end, and inside one
    ordinal the groups' ranges strictly rising."""
    tr_range = np.asarray(tr_range)
    n_ord = int(grp_ord.max(initial=-1)) + 1
    for ids, ords in zip(grp_ids, grp_ord):
        n_real = int((ords >= 0).sum())
        assert (ords[n_real:] == -1).all() and (ords[:n_real] >= 0).all()
        real_ords, real_ids = ords[:n_real], ids[:n_real].astype(np.int64)
        assert (np.diff(real_ords) >= 0).all()
        ranges = tr_range[real_ids]
        same = real_ords[1:] == real_ords[:-1]
        assert (np.diff(ranges)[same] > 0).all()
    args = (grp_ids, grp_ord, tr_range, n_ord, n_docs, rs)
    assert layout_ok_numpy(*args).all()
    assert exact_kernel.compact_rows_in_layout(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in args[:3]), *args[3:]
    ).all()


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("corpus", ["random", "synth"])
def test_compact_layout_of_planning(lockstep_case, corpus, subset):
    # The rows `_assemble_compact` writes keep E3's layout, on a random
    # corpus (with a repeated and an absent term) and a synthetic one, for
    # the whole batch and for a dispatch's subset of it.
    if corpus == "random":
        seg, queries, _, _ = lockstep_case
    else:
        from vectorchord_bm25_tpu_torch.data.synth import (
            synth_corpus_postings, synth_queries_fast,
        )

        keys, doc_ids, tfs, doc_start = synth_corpus_postings(4096, 3000, 40, seed=3)
        seg = build_sealed_segment_from_postings(keys, doc_ids, tfs, 4096, doc_grouped=True)
        queries = synth_queries_fast(keys, doc_start, seg, 64, seed=4)
    _, port = both(seg, compact=True)
    lists = port._grp_lists(*looked_up(port, queries))
    sub = np.arange(len(queries))
    if subset:
        sub = np.sort(np.random.default_rng(5).choice(len(queries), len(queries) // 2, replace=False))
    grp_ids, grp_ord = port._assemble_compact(lists, sub)
    assert (grp_ord >= 0).any()
    assert_compact_layout(
        grp_ids, grp_ord, port._ranges.tr_range, seg.n_docs, port._ranges.range_size
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_layout_check_matches_numpy(lockstep_case, seed):
    # `compact_rows_in_layout` against the entry-by-entry walk, on planned
    # rows with entries swapped, ordinals and ids past their ranges, and
    # pads moved forward.
    seg, queries, _, _ = lockstep_case
    _, port = both(seg, compact=True)
    grp_ids, grp_ord = port._prepare_compact(*looked_up(port, queries))
    tr_range = port._ranges.tr_range
    rng = np.random.default_rng(seed)
    q, g = grp_ids.shape
    for row in rng.choice(q, q // 2, replace=False):
        i, j = rng.integers(0, g, 2)
        kind = rng.integers(0, 4)
        if kind == 0:
            grp_ids[row, [i, j]] = grp_ids[row, [j, i]]
            grp_ord[row, [i, j]] = grp_ord[row, [j, i]]
        elif kind == 1:
            grp_ord[row, i] = rng.integers(-3, int(grp_ord.max()) + 3)
        elif kind == 2:
            grp_ids[row, i] = rng.integers(-2, tr_range.size + 2)
        else:
            grp_ord[row, : i + 1] = -1
    n_ord = int(grp_ord.max()) + 1
    want = layout_ok_numpy(grp_ids, grp_ord, tr_range, n_ord, seg.n_docs, port._ranges.range_size)
    got = exact_kernel.compact_rows_in_layout(
        torch.from_numpy(grp_ids), torch.from_numpy(grp_ord), torch.from_numpy(tr_range),
        n_ord, seg.n_docs, port._ranges.range_size,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_wrappers_check_inputs():
    pd = torch.zeros((3, 128), dtype=torch.int32)
    pi = torch.zeros((3, 128))
    live = torch.ones(5)
    win = torch.zeros((2, 8), dtype=torch.int32)
    acc = exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win, 1, 4)
    assert acc.shape == (2, 5) and acc.stride(0) % 4 == 0 and not acc.any()
    with pytest.raises(TypeError):
        exact_kernel.exact_dense_accumulate(pd, pi.double(), live, win, win, win, win, 1, 4)
    with pytest.raises(TypeError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win.long(), win, win, win, 1, 4)
    with pytest.raises(TypeError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win.long(), 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win[:1], 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win, -1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live[:4], win, win, win, win, 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(
            pd, pi, live, win, win, win, win, 1, 4, filter_mask=live[:4]
        )
    with pytest.raises(TypeError):
        exact_kernel.exact_dense_accumulate(
            pd, pi, live, win, win, win, win, 1, 4, filter_mask=live.double()
        )
    with pytest.raises(ValueError):
        exact_kernel.exact_sparse_gather(pd, pi, live, live[:4], win, win, win, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_sparse_gather(pd, pi, live, live, win, win[:1], win, 4)
    loc = torch.zeros(64, dtype=torch.uint8)
    tr = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        exact_kernel.exact_compact_accumulate(torch.zeros(64), loc, tr, tr, win, win, 1, 4, 128)
    with pytest.raises(ValueError):
        exact_kernel.exact_compact_accumulate(
            torch.zeros(64), loc, tr[:3], tr, win, win, 1, 4, 512
        )
    # The launch counts move only where a kernel is launched: never on the CPU.
    assert exact_kernel.DENSE_LAUNCHES == exact_kernel.DENSE_BF16_LAUNCHES == 0
    assert exact_kernel.SPARSE_LAUNCHES == exact_kernel.COMPACT_LAUNCHES == 0


# --- replay of tests/test_exact.py, in each form of the engine


@pytest.mark.parametrize("form", FORMS)
class TestExactEngine:
    @pytest.mark.parametrize("n_docs,vocab", [(50, 20), (300, 10), (40, 200)])
    def test_vs_scalar_oracle(self, rng, form, n_docs, vocab):
        docs = make_docs(rng, n_docs, vocab=vocab)
        options = IndexOptions()
        seg = build_sealed_segment(docs, options=options)
        ref, engine = both(seg, **FORMS[form])
        queries = [
            Query.from_int_ids(rng.integers(0, vocab, size=3).tolist())
            for _ in range(8)
        ]
        k = 10
        scores, ids, payloads = engine.search(queries, k)
        assert_same((scores, ids, payloads), ref.search(queries, k))
        for qi, q in enumerate(queries):
            e_scores, e_ids = scalar_topk(docs, q, k, options)
            got_valid = ids[qi][ids[qi] >= 0]
            assert len(got_valid) == len(e_ids)
            rank_match(got_valid, e_ids, scores[qi][: len(e_ids)], e_scores)
            np.testing.assert_allclose(scores[qi][: len(e_ids)], e_scores, rtol=1e-5)

    def test_missing_terms_skipped(self, rng, form):
        seg = build_sealed_segment(make_docs(rng, 20, vocab=10))
        ref, engine = both(seg, **FORMS[form])
        q_both = Query.from_int_ids([0, 999999])
        q_present = Query.from_int_ids([0])
        s1, i1, _ = engine.search([q_both], 5)
        s2, i2, _ = engine.search([q_present], 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(s1, s2)
        assert_same(engine.search([q_both], 5), ref.search([q_both], 5))

    def test_all_terms_missing(self, rng, form):
        seg = build_sealed_segment(make_docs(rng, 20, vocab=10))
        _, engine = both(seg, **FORMS[form])
        scores, ids, payloads = engine.search([Query.from_int_ids([999999])], 5)
        assert np.all(ids == -1)
        assert np.all(payloads == -1)
        assert np.all(np.isneginf(scores))

    def test_fewer_matches_than_k(self, rng, form):
        docs = [Document.from_int_ids([1]), Document.from_int_ids([2])]
        seg = build_sealed_segment(docs)
        ref, engine = both(seg, **FORMS[form])
        scores, ids, _ = engine.search([Query.from_int_ids([1])], 10)
        assert scores.shape == (1, 10)  # fewer doc slots than k: padded back
        assert (ids[0] >= 0).sum() == 1
        assert ids[0][0] == 0
        assert_same(engine.search([Query.from_int_ids([1])], 10),
                    ref.search([Query.from_int_ids([1])], 10))

    def test_oracle_topk_matches_engine(self, rng, form):
        seg = build_sealed_segment(make_docs(rng, 100, vocab=15))
        _, engine = both(seg, **FORMS[form])
        q = Query.from_int_ids([1, 2, 3])
        scores, ids, _ = engine.search([q], 10)
        o_scores, o_ids = oracle_topk(engine.segment, q, 10)
        got = ids[0][ids[0] >= 0]
        rank_match(got, o_ids, scores[0][: len(o_ids)], o_scores)

    def test_filter_mask_prefilter(self, rng, form):
        seg = build_sealed_segment(make_docs(rng, 100, vocab=5))
        ref, engine = both(seg, **FORMS[form])
        q = Query.from_int_ids([0, 1])
        mask = np.zeros(100, dtype=bool)
        mask[::3] = True  # keep every third doc
        scores, ids, _ = engine.search([q], 10, filter_mask=mask)
        valid = ids[0][ids[0] >= 0]
        assert np.all(valid % 3 == 0)
        # Prefilter semantics: same as scoring only the masked corpus.
        o_scores, o_ids = oracle_topk(engine.segment, q, 10, filter_mask=mask)
        rank_match(valid, o_ids, scores[0][: len(o_ids)], o_scores)
        assert_same(engine.search([q], 10, filter_mask=mask),
                    ref.search([q], 10, filter_mask=mask))

    def test_payload_mapping(self, rng, form):
        docs = make_docs(rng, 10, vocab=3)
        payloads = (np.arange(10) * 7 + 1000).tolist()
        seg = build_sealed_segment(docs, payloads=payloads)
        _, engine = both(seg, **FORMS[form])
        scores, ids, got_payloads = engine.search([Query.from_int_ids([0])], 5)
        assert (ids[0] >= 0).any()
        for slot, payload in zip(ids[0], got_payloads[0]):
            if slot >= 0:
                assert payload == payloads[slot]
            else:
                assert payload == -1

    def test_deleted_docs_excluded(self, rng, form):
        docs = make_docs(rng, 50, vocab=5)
        seg = build_sealed_segment(docs)
        ref, engine = both(seg, **FORMS[form])
        deleted = np.zeros(50, dtype=bool)
        deleted[:25] = True
        engine.set_deleted(deleted)
        ref.set_deleted(deleted)
        q = Query.from_int_ids([0, 1, 2])
        scores, ids, _ = engine.search([q], 20)
        valid = ids[0][ids[0] >= 0]
        assert np.all(valid >= 25)
        e_scores, e_ids = scalar_topk(docs, q, 20, seg.options, deleted=deleted)
        rank_match(valid, e_ids, scores[0][: len(e_ids)], e_scores)
        assert_same(engine.search([q], 20), ref.search([q], 20))

    def test_k_zero_rejected(self, rng, form):
        _, engine = both(build_sealed_segment(make_docs(rng, 5)), **FORMS[form])
        with pytest.raises(ValueError, match="number of needed rows"):
            engine.search([Query.from_int_ids([0])], 0)

    def test_tie_break_doc_asc(self, form):
        # Identical docs => identical scores => doc slot ascending.
        docs = [Document.from_int_ids([7]) for _ in range(5)]
        _, engine = both(build_sealed_segment(docs), **FORMS[form])
        scores, ids, _ = engine.search([Query.from_int_ids([7])], 5)
        assert ids[0].tolist() == [0, 1, 2, 3, 4]
        assert len(set(np.asarray(scores[0]).tolist())) == 1

    def test_unknown_strategy_rejected(self, rng, form):
        seg = segment_from_reference(build_sealed_segment(make_docs(rng, 5)))
        with pytest.raises(ValueError, match="unknown strategy"):
            ExactEngine(seg, device="cpu", strategy=form + "?")


@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", FORMS)
def test_engine_equals_reference(rng, form, impact_dtype):
    # A whole batch through cost buckets (a heavy-tail query among light
    # ones) and the accumulator cap, with deletes and a filter.
    n_docs, vocab = 3000, 400
    docs = make_docs(rng, n_docs, vocab=vocab)
    for i in range(0, n_docs, 2):
        docs[i] = Document.from_int_ids([0, 1] + rng.integers(2, vocab, size=4).tolist())
    seg = build_sealed_segment(docs, payloads=np.arange(n_docs) * 3 + 5)
    opts = {**FORMS[form], "impact_dtype": impact_dtype, "accumulator_budget": 1 << 20}
    ref, engine = both(seg, **opts)
    queries = _queries(rng, 700, vocab, terms=(1, 4)) + [
        Query.from_int_ids([0, 1, 2, 3, 4, 5, 6, 7]),
        repeated_query([3, 5]),
    ]
    deleted = rng.random(n_docs) < 0.1
    fmask = rng.random(n_docs) < 0.7
    assert_same(engine.search(queries, 10), ref.search(queries, 10))
    engine.set_deleted(deleted)
    ref.set_deleted(deleted)
    got = engine.search(queries, 7, filter_mask=fmask)
    assert_same(got, ref.search(queries, 7, filter_mask=fmask))
    assert (got[1] >= 0).any() and (deleted | ~fmask)[got[1][got[1] >= 0]].sum() == 0
    assert engine.memory_report() == ref.memory_report()


def test_from_reference_copies_state(rng):
    seg = build_sealed_segment(make_docs(rng, 300, vocab=20))
    deleted = rng.random(300) < 0.2
    queries = _queries(rng, 16, 20)
    for opts in ({}, {"strategy": "sparse"}, {"compact": True, "impact_dtype": "bfloat16"}):
        ref = ref_exact.ExactEngine(seg, accumulator_budget=1 << 22, **opts)
        ref.set_deleted(deleted)
        port = ExactEngine.from_reference(ref, device="cpu")
        assert port.segment is not seg and port.strategy == ref.strategy
        assert port.compact == ref.compact and port.accumulator_budget == 1 << 22
        assert_same(port.search(queries, 10), ref.search(queries, 10))
        assert port.memory_report() == ref.memory_report()
    shared = ref_exact.ExactEngine(seg, share=RefBlockMax(seg))
    port = ExactEngine.from_reference(shared, device="cpu")
    assert port.compact
    assert_same(port.search(queries, 10), shared.search(queries, 10))
    port = ExactEngine.from_reference(seg, device="cpu", deleted=deleted, strategy="sparse")
    ref = ref_exact.ExactEngine(seg, strategy="sparse")
    ref.set_deleted(deleted)
    assert_same(port.search(queries, 10), ref.search(queries, 10))


# --- replay of tests/test_sparse_exact.py


def _engines(seg):
    pseg = segment_from_reference(seg)
    return ExactEngine(pseg, device="cpu", strategy="dense"), ExactEngine(
        pseg, device="cpu", strategy="sparse"
    )


def _assert_parity(seg, dense, sparse, queries, k):
    s_d, i_d, p_d = dense.search(queries, k)
    s_s, i_s, p_s = sparse.search(queries, k)
    np.testing.assert_array_equal(i_s >= 0, i_d >= 0)
    np.testing.assert_allclose(s_s, s_d, rtol=1e-5, atol=1e-6)
    for qi in range(len(queries)):
        for j in range(k):
            if i_s[qi, j] != i_d[qi, j] and i_d[qi, j] >= 0:
                # only exact f32 ties may reorder
                assert abs(s_s[qi, j] - s_d[qi, j]) <= 1e-6 * abs(s_d[qi, j]), (
                    qi, j, i_s[qi, j], i_d[qi, j],
                )
    # And the port's sparse strategy is the reference's, bit for bit.
    assert_same((s_s, i_s, p_s), ref_exact.ExactEngine(seg, strategy="sparse").search(queries, k))


@pytest.mark.parametrize("n_docs,vocab,terms", [(200, 12, 3), (500, 40, 6)])
def test_sparse_matches_dense(rng, n_docs, vocab, terms):
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    dense, sparse = _engines(seg)
    queries = [
        Query.from_int_ids(rng.integers(0, vocab, size=terms).tolist())
        for _ in range(16)
    ]
    _assert_parity(seg, dense, sparse, queries, 10)


def test_sparse_heavy_duplicate_docs(rng):
    # Every doc matches every query term: maximal segment lengths.
    docs = [
        Document.from_int_ids([0, 1, 2, 3, 4, 5, 6, 7] * (1 + i % 3))
        for i in range(64)
    ]
    seg = build_sealed_segment(docs)
    dense, sparse = _engines(seg)
    queries = [Query.from_int_ids([0, 1, 2, 3, 4, 5, 6, 7])]
    _assert_parity(seg, dense, sparse, queries, 20)


def test_sparse_missing_and_empty_queries(rng):
    seg = build_sealed_segment(make_docs(rng, 50, vocab=8))
    _, sparse = _engines(seg)
    s, i, p = sparse.search(
        [Query.from_int_ids([999999]), Query(keys=np.zeros(0, dtype="S16"))], 5
    )
    assert np.all(i == -1)
    assert np.all(p == -1)


def test_sparse_deleted_and_filter(rng):
    docs = make_docs(rng, 120, vocab=6)
    seg = build_sealed_segment(docs)
    dense, sparse = _engines(seg)
    deleted = np.zeros(len(docs), dtype=bool)
    deleted[rng.integers(0, len(docs), size=30)] = True
    dense.set_deleted(deleted)
    sparse.set_deleted(deleted)
    fmask = rng.random(len(docs)) < 0.5
    queries = [
        Query.from_int_ids(rng.integers(0, 6, size=3).tolist()) for _ in range(8)
    ]
    s_d, i_d, _ = dense.search(queries, 10, filter_mask=fmask)
    s_s, i_s, _ = sparse.search(queries, 10, filter_mask=fmask)
    np.testing.assert_allclose(s_s, s_d, rtol=1e-5, atol=1e-6)
    live = ~deleted & fmask
    assert (i_s >= 0).any()
    for qi in range(len(queries)):
        for d in i_s[qi][i_s[qi] >= 0]:
            assert live[d]


def test_sparse_vs_oracle_ranks(rng):
    seg = build_sealed_segment(make_docs(rng, 300, vocab=25))
    _, sparse = _engines(seg)
    queries = [
        Query.from_int_ids(rng.integers(0, 25, size=4).tolist()) for _ in range(12)
    ]
    scores, ids, _ = sparse.search(queries, 10)
    for qi, q in enumerate(queries):
        o_scores, o_ids = oracle_topk(sparse.segment, q, 10)
        got = ids[qi][ids[qi] >= 0]
        assert len(got) == len(o_ids)
        for j, (g, e) in enumerate(zip(got, o_ids)):
            if g != e:
                assert abs(scores[qi][j] - o_scores[j]) < 1e-4


def test_sparse_single_term_no_steps(rng):
    seg = build_sealed_segment(make_docs(rng, 80, vocab=5))
    dense, sparse = _engines(seg)
    _assert_parity(seg, dense, sparse, [Query.from_int_ids([2])], 10)


def test_auto_strategy_threshold(rng, monkeypatch):
    seg = segment_from_reference(build_sealed_segment(make_docs(rng, 30, vocab=5)))
    eng = ExactEngine(seg, device="cpu")  # auto
    assert eng.strategy == "auto"
    assert ExactEngine.SPARSE_MIN_DOCS == ref_exact.ExactEngine.SPARSE_MIN_DOCS
    # Small corpus: auto stays dense; search still works end to end.
    calls = []
    monkeypatch.setattr(
        exact_kernel, "exact_sparse_gather_plain",
        lambda *a: calls.append(a) or exact_kernel.exact_sparse_gather_plain(*a),
    )
    s, i, _ = eng.search([Query.from_int_ids([1, 2])], 5)
    assert s.shape == (1, 5) and not calls
    # At the threshold auto takes the sparse path, with the same results.
    monkeypatch.undo()
    real = exact_kernel.exact_sparse_gather_plain
    monkeypatch.setattr(
        exact_kernel, "exact_sparse_gather_plain",
        lambda *a: calls.append(a) or real(*a),
    )
    monkeypatch.setattr(ExactEngine, "SPARSE_MIN_DOCS", 30)
    s2, i2, _ = eng.search([Query.from_int_ids([1, 2])], 5)
    assert calls
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_array_equal(s, s2)


# --- replay of tests/test_compact_exact.py


class TestCompactExact:
    @pytest.mark.parametrize("n_docs,vocab", [(200, 20), (500, 8), (64, 100)])
    def test_matches_dense_engine(self, rng, n_docs, vocab):
        seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
        pseg = segment_from_reference(seg)
        dense = ExactEngine(pseg, device="cpu")
        compact = ExactEngine(pseg, device="cpu", compact=True)
        ref = ref_exact.ExactEngine(seg, compact=True)
        queries = [
            Query.from_int_ids(rng.integers(0, vocab, size=3).tolist())
            for _ in range(6)
        ]
        for k in (1, 10):
            s1_, i1, p1 = dense.search(queries, k)
            s2_, i2, p2 = compact.search(queries, k)
            assert_same((s2_, i2, p2), ref.search(queries, k))
            for qi in range(len(queries)):
                g1 = i1[qi][i1[qi] >= 0]
                g2 = i2[qi][i2[qi] >= 0]
                assert len(g1) == len(g2), f"q{qi} k={k}"
                rank_match(g2, g1, s2_[qi][: len(g2)], s1_[qi][: len(g1)])
                np.testing.assert_allclose(
                    s2_[qi][: len(g2)], s1_[qi][: len(g1)], rtol=1e-5
                )

    def test_deletes_and_filters(self, rng):
        seg = segment_from_reference(build_sealed_segment(make_docs(rng, 300, vocab=15)))
        dense = ExactEngine(seg, device="cpu")
        compact = ExactEngine(seg, device="cpu", compact=True)
        deleted = rng.random(300) < 0.3
        dense.set_deleted(deleted)
        compact.set_deleted(deleted)
        fmask = rng.random(300) < 0.5
        queries = [
            Query.from_int_ids(rng.integers(0, 15, size=4).tolist())
            for _ in range(4)
        ]
        s1_, i1, _ = dense.search(queries, 10, filter_mask=fmask)
        s2_, i2, _ = compact.search(queries, 10, filter_mask=fmask)
        np.testing.assert_array_equal(i1 >= 0, i2 >= 0)
        assert (i1 >= 0).any()
        for qi in range(len(queries)):
            g = i1[qi] >= 0
            rank_match(i2[qi][g], i1[qi][g], s2_[qi][g], s1_[qi][g])

    def test_share_from_blockmax(self, rng):
        seg = segment_from_reference(build_sealed_segment(make_docs(rng, 200, vocab=12)))
        bm = BlockMaxEngine(seg, device="cpu")
        shared = ExactEngine(seg, share=bm)
        assert shared.dev is bm.dev
        assert shared.dev_post_impact is bm.dev_post_impact
        # One copy: the same storage, not equal tensors.
        for name in ("dev_post_impact", "dev_post_local", "dev_tr_range", "dev_tr_start"):
            assert getattr(shared, name).data_ptr() == getattr(bm, name).data_ptr()
        standalone = ExactEngine(seg, device="cpu")
        queries = [
            Query.from_int_ids(rng.integers(0, 12, size=3).tolist())
            for _ in range(4)
        ]
        s1_, i1, _ = standalone.search(queries, 10)
        s2_, i2, _ = shared.search(queries, 10)
        np.testing.assert_array_equal(i1 >= 0, i2 >= 0)
        for qi in range(len(queries)):
            g = i1[qi] >= 0
            rank_match(i2[qi][g], i1[qi][g], s2_[qi][g], s1_[qi][g])
        # Deletes set on the Block-Max engine reach the shared engine.
        deleted = np.zeros(200, dtype=bool)
        deleted[i2[0][0]] = True
        bm.set_deleted(deleted)
        assert i2[0][0] not in shared.search(queries, 10)[1][0].tolist()

    def test_share_wrong_segment_errors(self, rng):
        docs = make_docs(rng, 50, vocab=6)
        seg_a = segment_from_reference(build_sealed_segment(docs))
        seg_b = segment_from_reference(build_sealed_segment(docs))
        bm = BlockMaxEngine(seg_a, device="cpu")
        with pytest.raises(ValueError, match="same sealed segment"):
            ExactEngine(seg_b, share=bm)
        tf = BlockMaxEngine(seg_a, device="cpu", posting_mode="tf")
        with pytest.raises(ValueError, match="posting_mode='impact'"):
            ExactEngine(seg_a, share=tf)

    def test_hybrid_shares_one_copy(self, rng):
        seg = segment_from_reference(build_sealed_segment(make_docs(rng, 400, vocab=10)))
        hyb = HybridEngine(
            seg, route_threshold=100.0, memory_mode="compact", device="cpu"
        )  # force dense route, shared arrays
        queries = [
            Query.from_int_ids(rng.integers(0, 10, size=3).tolist())
            for _ in range(4)
        ]
        s, i, p = hyb.search(queries, 10)
        assert hyb._exact is not None, "dense route should have been taken"
        assert hyb._exact.dev is hyb.blockmax.dev
        # Delete mask set once propagates to both strategies.
        deleted = np.zeros(400, dtype=bool)
        live_ids = i[0][i[0] >= 0]
        assert live_ids.size
        deleted[live_ids[0]] = True
        hyb.set_deleted(deleted)
        s2, i2, _ = hyb.search(queries, 10)
        assert live_ids[0] not in set(i2[0].tolist())
        bm = BlockMaxEngine(seg, device="cpu")
        bm.set_deleted(deleted)
        s3, i3, _ = bm.search(queries, 10)
        np.testing.assert_array_equal(i2 >= 0, i3 >= 0)


class TestMemoryParity:
    def test_reference_format_tiny(self):
        # The reference's byte model reads a port segment as its own.
        doc = Document.from_int_ids([7])
        seg = segment_from_reference(build_sealed_segment([doc]))
        ref = reference_format_bytes(seg)
        assert ref["total"] == 67
        assert ref["postings"] == 1

    def test_compact_beats_dense_and_tracks_reference(self, rng):
        seg = build_sealed_segment(make_docs(rng, 2000, vocab=50))
        ref_dense, dense = both(seg)
        ref_compact, compact = both(seg, compact=True)
        d_rep = dense.memory_report()
        c_rep = compact.memory_report()
        assert d_rep == ref_dense.memory_report()
        assert c_rep == ref_compact.memory_report()
        assert c_rep["total"] < d_rep["total"]
        # Flat form: 5 B/posting + group metadata.
        assert c_rep["bytes_per_posting"] < 8.0
        parity = memory_parity_report(compact, seg)
        assert parity == memory_parity_report(ref_compact, seg)
        assert parity["device_bytes"] == c_rep["total"]
        assert parity["ratio_vs_reference"] > 0

    @pytest.mark.parametrize(
        "opts",
        [{}, {"impact_dtype": "bfloat16"}, {"compact": True},
         {"compact": True, "impact_dtype": "bfloat16"}],
        ids=["dense", "dense-bf16", "compact", "compact-bf16"],
    )
    def test_engines_all_report(self, rng, opts):
        seg = build_sealed_segment(make_docs(rng, 300, vocab=20))
        ref, engine = both(seg, **opts)
        rep = engine.memory_report()
        assert rep == ref.memory_report()
        assert rep["total"] > 0
        assert rep["bytes_per_posting"] > 0


# --- the facade's engine="exact" cases


def _grow_queries(rng, n, vocab):
    return [
        Query.from_int_ids(np.unique(rng.integers(0, vocab, size=3)).tolist())
        for _ in range(n)
    ]


def hits_of(results):
    return [[(h.score, h.payload) for h in hits] for hits in results]


class TestFacadeExact:
    def test_batched_matches_single_query_path(self):
        # tests/test_growing_batch.py:47 on the port, and against the
        # reference facade.
        rng = np.random.default_rng(77)
        vocab = 60
        sealed_docs = make_docs(rng, 300, vocab=vocab)
        grow_docs = make_docs(rng, 80, vocab=vocab)
        seed = random_seed()
        idx = Bm25Index.build(sealed_docs, engine="exact", seed=seed, device="cpu")
        ref = RefIndex.build(sealed_docs, engine="exact", seed=seed)
        for j, d in enumerate(grow_docs):
            idx.insert(d, payload=1000 + j)
            ref.insert(d, payload=1000 + j)
        assert type(idx.engine()) is ExactEngine
        queries = _grow_queries(rng, 32, vocab)
        got = idx.search_batch(queries, k=10)
        for q, g_hits in zip(queries, got):
            w_hits = idx.search(q, k=10)
            assert [h.payload for h in g_hits] == [h.payload for h in w_hits]
            np.testing.assert_allclose(
                [h.score for h in g_hits], [h.score for h in w_hits], rtol=1e-6
            )
        assert any(h.payload >= 1000 for row in got for h in row)
        assert hits_of(got) == hits_of(ref.search_batch(queries, k=10))

    def test_growing_only_index(self):
        # tests/test_growing_batch.py:112
        rng = np.random.default_rng(77)
        docs, grown = make_docs(rng, 5, vocab=20), make_docs(rng, 50, vocab=20)
        seed = random_seed()
        idx = Bm25Index.build(docs, engine="exact", seed=seed, device="cpu")
        ref = RefIndex.build(docs, engine="exact", seed=seed)
        for j, d in enumerate(grown):
            idx.insert(d, payload=100 + j)
            ref.insert(d, payload=100 + j)
        queries = _grow_queries(rng, 8, 20)
        hits = idx.search_batch(queries, k=60)
        assert any(h.payload >= 100 for row in hits for h in row)
        assert hits_of(hits) == hits_of(ref.search_batch(queries, k=60))

    def test_growing_does_not_change_sealed_results(self):
        # tests/test_growing_batch.py:128 without its clock: a large
        # growing segment beside the exact engine; the sealed docs' ranking
        # is the reference facade's, growing hits merged in.
        rng = np.random.default_rng(77)
        vocab, n_sealed, n_grow = 500, 4000, 1000
        docs = make_docs(rng, n_sealed, vocab=vocab)
        seed = random_seed()
        idx = Bm25Index.build(docs, engine="exact", seed=seed, device="cpu")
        ref = RefIndex.build(docs, engine="exact", seed=seed)
        queries = _grow_queries(rng, 64, vocab)
        assert hits_of(idx.search_batch(queries, k=10)) == hits_of(
            ref.search_batch(queries, k=10)
        )
        for j, d in enumerate(make_docs(rng, n_grow, vocab=vocab)):
            idx.insert(d, payload=n_sealed + j)
            ref.insert(d, payload=n_sealed + j)
        hits = idx.search_batch(queries, k=10)
        assert any(h.payload >= n_sealed for row in hits for h in row)
        assert hits_of(hits) == hits_of(ref.search_batch(queries, k=10))

    def test_prefilter_vectorized_and_cached(self):
        # tests/test_prefilter.py:123 at a smaller size and without its
        # clock: the prefilter mask of an engine="exact" index comes from
        # one vectorized predicate call and is cached.
        n_docs = 100_000
        g = np.random.default_rng(5)
        lengths = g.integers(3, 9, size=n_docs)
        total = int(lengths.sum())
        doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
        ids = g.integers(0, 30_000, size=total)
        order = np.lexsort((ids, doc_of))
        d_s, i_s = doc_of[order], ids[order]
        keep = np.ones(total, dtype=bool)
        keep[1:] = (d_s[1:] != d_s[:-1]) | (i_s[1:] != i_s[:-1])
        kb = np.zeros((int(keep.sum()), 16), dtype=np.uint8)
        kb[:, :4] = i_s[keep].astype(">u4").view(np.uint8).reshape(-1, 4)
        seg = build_sealed_segment_from_postings(
            kb.reshape(-1).view("S16"), d_s[keep],
            np.ones(int(keep.sum()), dtype=np.int64), n_docs, doc_grouped=True,
        )
        seed = random_seed()
        idx = Bm25Index(
            segment_from_reference(seg), seed, PortIndexOptions(),
            search_options=PortSearchOptions(prefilter=True), engine="exact",
            device="cpu",
        )
        ref = RefIndex(
            seg, seed, IndexOptions(), search_options=SearchOptions(prefilter=True),
            engine="exact",
        )
        q = Query.from_int_ids([7, 11])
        calls = []

        def pred(p):
            calls.append(np.ndim(p))
            return p % 3 == 0

        hits = idx.search(q, k=10, filter_fn=pred)
        for _ in range(3):
            assert hits_of([idx.search(q, k=10, filter_fn=pred)]) == hits_of([hits])
        assert calls == [1]  # one vectorized evaluation, then the cache
        assert hits and all(h.payload % 3 == 0 for h in hits)
        assert hits_of([hits]) == hits_of([ref.search(q, k=10, filter_fn=pred)])
