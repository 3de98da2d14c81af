"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips unless torch sees a CUDA device (nvcc
builds the kernel at first use).  A CUDA install need not have jax, so run
these without the jax-forcing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Query  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import score_kernel  # noqa: E402
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402

from test_sealed import make_docs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


@pytest.mark.parametrize("q,t,c,rs", [(2, 3, 4, 128), (64, 4, 32, 128), (5, 2, 3, 256), (3, 1, 2, 32)])
def test_kernel_matches_plain_with_collisions(card, gen, q, t, c, rs):
    p = 8192
    post_local = torch.from_numpy(gen.integers(0, rs, size=p).astype(np.uint8))
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32))
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(q, t, c)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(q, t, c)).astype(np.int32))
    args = [x.to(card) for x in (post_impact, post_local, starts, lens)]
    before = score_kernel.LAUNCHES
    got = score_kernel.fused_range_scores(*args, rs=rs)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES == before + 1
    want = score_kernel.fused_range_scores_plain(*args, rs=rs)
    # Colliding slots add in atomic order on both sides.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cpu = score_kernel.fused_range_scores(
        post_impact, post_local, starts, lens, rs=rs
    )
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-6)


def test_kernel_drops_out_of_range_slots(card, gen):
    p, rs = 8192, 64
    post_local = torch.from_numpy(gen.integers(0, 256, size=p).astype(np.uint8))
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32))
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(8, 3, 16)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(8, 3, 16)).astype(np.int32))
    args = [x.to(card) for x in (post_impact, post_local, starts, lens)]
    got = score_kernel.fused_range_scores(*args, rs=rs)
    torch.cuda.synchronize()
    want = score_kernel.fused_range_scores_plain(*args, rs=rs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_zero_lengths(card):
    imp = torch.rand(1024, device=card)
    loc = torch.zeros(1024, dtype=torch.uint8, device=card)
    st = torch.zeros((1, 2, 2), dtype=torch.int32, device=card)
    out = score_kernel.fused_range_scores(imp, loc, st, st, rs=128)
    assert out.shape == (1, 2, 128) and not out.any()


def test_kernel_rejects_wrong_dtype(card):
    imp = torch.rand(1024, device=card, dtype=torch.float64)
    loc = torch.zeros(1024, dtype=torch.uint8, device=card)
    st = torch.zeros((1, 2, 2), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        score_kernel.fused_range_scores(imp, loc, st, st, rs=128)


@pytest.mark.parametrize("n_docs,vocab,range_size", [(3000, 40, 128), (1000, 30, 64)])
def test_engine_on_card_equals_cpu(card, gen, n_docs, vocab, range_size):
    seg = build_sealed_segment(make_docs(gen, n_docs, vocab=vocab))
    ri = build_range_index(seg, range_size=range_size)
    on_card = BlockMaxEngine(seg, ri, chunk=4, device=card)
    on_cpu = BlockMaxEngine(seg, ri, chunk=4, device="cpu")
    deleted = gen.random(n_docs) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(n_docs) < 0.7
    queries = [
        Query.from_int_ids(gen.integers(0, vocab, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for kw in ({}, {"filter_mask": fmask}):
        before = score_kernel.LAUNCHES
        got = on_card.search(queries, 10, **kw)
        assert score_kernel.LAUNCHES > before
        want = on_cpu.search(queries, 10, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()


# --- the stream engine's kernels: S1 stream_dense_accumulate, S2 dense_topk


def _stream_case(gen, n_docs=20_000, tf_hi=400):
    """A stream index with every doc width class (terms stepping 1, 6, 100
    and 1,000 docs) and tf widths up to 16 bits, and a random dispatch of
    its windows: (engine tables on the card, wsrc, wq, word_ord, n_q)."""
    from vectorchord_bm25_tpu.index.sealed import build_sealed_segment_from_postings
    from vectorchord_bm25_tpu.index.stream import build_stream_index

    toks, docs = [], []
    for tid, step in enumerate((1, 6, 100, 1000)):
        d = np.arange(int(gen.integers(0, step)), n_docs, step)
        toks.append(np.full(d.size, tid))
        docs.append(d)
    for tid in range(4, 40):
        d = np.unique(gen.integers(0, n_docs, size=int(gen.integers(1, 3000))))
        toks.append(np.full(d.size, tid))
        docs.append(d)
    tok, doc = np.concatenate(toks), np.concatenate(docs)
    tf = gen.integers(1, tf_hi + 1, size=tok.size)
    keys = np.zeros((tok.size, 16), dtype=np.uint8)
    keys[:, :4] = tok.astype(">u4").view(np.uint8).reshape(-1, 4)
    order = np.lexsort((doc, tok))
    seg = build_sealed_segment_from_postings(
        keys.reshape(-1).view("S16")[order], doc[order], tf[order], n_docs,
        presorted=True,
    )
    si = build_stream_index(seg)
    assert set(np.unique(si.w_dbits)) == {2, 4, 8, 16}
    s1 = si.s1_table[si.doc_fn & 0xFF].astype(np.float32)
    s1[gen.random(n_docs + 1) < 0.2] = np.inf
    s1[n_docs] = np.inf
    tables = [
        torch.from_numpy(x).cuda()
        for x in (
            si.words.view(np.int32),
            s1,
            np.append(si.w_off4, si.words.size - 64).astype(np.int32),
            np.append(si.w_base, 0).astype(np.int32),
            np.append(si.w_meta16(), 0).astype(np.uint16).view(np.int16),
            np.append(si.w_s0, 0.0).astype(np.float32),
        )
    ]
    wsrc, wq, word_ord = [], [], []
    tws = si.token_w_start
    n_q = 24
    for q in range(n_q):
        for o, tid in enumerate(gen.integers(0, si.n_tokens, size=int(gen.integers(1, 6)))):
            span = np.arange(tws[tid], tws[tid + 1])
            wsrc.append(span)
            wq.append(np.full(span.size, q))
            word_ord.append(np.full(span.size, o))
    wsrc, wq, word_ord = (np.concatenate(x) for x in (wsrc, wq, word_ord))
    pad = (-wsrc.size) % 128 or 128
    wsrc = np.append(wsrc, np.full(pad, si.n_windows)).astype(np.int32)
    wq = np.append(wq, np.zeros(pad)).astype(np.int32)
    word_ord = np.append(word_ord, np.zeros(pad)).astype(np.int64)
    return si, tables, wsrc, wq, word_ord, 32


def _port_lists(si, wsrc, wq, word_ord, n_q, device="cuda"):
    """A ``_stream_case`` dispatch in the port's form: (wsrc, q_start,
    w_ord) int32 tensors, the trailing pad windows outside every span with
    ordinal -1; the rows past the 24 queries own no window."""
    t = int((wsrc < si.n_windows).sum())
    q_start = np.searchsorted(wq[:t], np.arange(n_q + 1)).astype(np.int32)
    w_ord = np.where(np.arange(wsrc.size) < t, word_ord, -1).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (wsrc, q_start, w_ord)]


def _shuffled_spans(gen, q_start, n):
    """A permutation of n windows that shuffles each span in place."""
    qs = q_start.cpu().numpy()
    return torch.from_numpy(np.concatenate(
        [lo + gen.permutation(hi - lo) for lo, hi in zip(qs[:-1], qs[1:])]
        + [np.arange(qs[-1], n)]
    )).cuda()


@pytest.mark.parametrize("tf_hi", [1, 15, 400])
def test_stream_kernel_matches_plain(card, gen, tf_hi):
    from vectorchord_bm25_tpu_torch.ops import stream_kernel

    si, tables, wsrc, wq, word_ord, n_q = _stream_case(gen, tf_hi=tf_hi)
    ws, q_start, w_ord = _port_lists(si, wsrc, wq, word_ord, n_q)
    # The planning's order, and each span shuffled (off the layout: the
    # one-thread path): the ordinals alone fix the add order.
    perm = _shuffled_spans(gen, q_start, wsrc.size)
    assert stream_kernel.stream_spans_in_layout(ws, q_start, w_ord, tables[3]).all()
    assert not stream_kernel.stream_spans_in_layout(ws[perm], q_start, w_ord[perm], tables[3]).all()
    for lists in ((ws, q_start, w_ord), (ws[perm], q_start, w_ord[perm])):
        before = stream_kernel.LAUNCHES
        got = stream_kernel.stream_dense_accumulate(*tables, *lists, n_q, si.n_docs)
        torch.cuda.synchronize()
        assert stream_kernel.LAUNCHES == before + 1
        want = stream_kernel.stream_dense_accumulate_plain(*tables, *lists, n_q, si.n_docs)
        assert torch.equal(got, want)
        assert int((got > 0).sum()) > 1000
        cpu = stream_kernel.stream_dense_accumulate(
            *[t.cpu() for t in tables], *[x.cpu() for x in lists], n_q, si.n_docs,
        )
        assert torch.equal(got.cpu(), cpu)


def test_stream_kernel_rejects_bad_inputs(card, gen):
    from vectorchord_bm25_tpu_torch.ops import stream_kernel

    si, tables, wsrc, wq, word_ord, n_q = _stream_case(gen, n_docs=5_000)
    ws, qs, wo = _port_lists(si, wsrc, wq, word_ord, n_q)
    with pytest.raises(TypeError, match="wsrc"):
        stream_kernel.stream_dense_accumulate(
            *tables, ws.long(), qs, wo, n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="q_start"):
        stream_kernel.stream_dense_accumulate(
            *tables, ws, qs.cpu(), wo, n_q, si.n_docs
        )
    with pytest.raises(ValueError, match="contiguous"):
        stream_kernel.stream_dense_accumulate(
            *tables, torch.stack([ws, ws], 1)[:, 0], qs, wo, n_q, si.n_docs
        )
    with pytest.raises(TypeError, match="w_ord"):
        stream_kernel.stream_dense_accumulate(
            *tables, ws, qs, wo.long(), n_q, si.n_docs
        )


def _dirty_pool(n_q, n_docs):
    """Fill and free a block of the caching allocator's size for a [n_q,
    N+1] accumulator with NaN, so an uninitialised one that a kernel left a
    cell of shows it."""
    stride = (n_docs + 1 + 3) & ~3
    junk = torch.full((n_q, stride), float("nan"), device="cuda")
    del junk


def _rows_whole(acc):
    """The accumulator's rows with their stride padding."""
    return acc.as_strided((acc.shape[0], acc.stride(0)), (acc.stride(0), 1))


@pytest.mark.parametrize("tile", [4, 64, 1000, 8192, 16384, 32768])
def test_stream_tiles_equal_plain(card, gen, monkeypatch, tile):
    # Tiles of 4 to 32,768 cells over N+1 = 20,001: every window straddles
    # tiles at 4 and 64, the rare terms' windows (a posting every 1,000
    # docs) span every tile, and from 16,384 the tile takes shared memory
    # past 48 KB.  The rows past the queries own no window: all zeros, pad
    # column and stride padding included.
    from vectorchord_bm25_tpu_torch.ops import dense_tiles, stream_kernel

    si, tables, wsrc, wq, word_ord, n_q = _stream_case(gen, tf_hi=15)
    lists = _port_lists(si, wsrc, wq, word_ord, n_q)
    monkeypatch.setattr(dense_tiles, "TILE", tile)
    _dirty_pool(n_q, si.n_docs)
    got = stream_kernel.stream_dense_accumulate(*tables, *lists, n_q, si.n_docs)
    want = stream_kernel.stream_dense_accumulate_plain(*tables, *lists, n_q, si.n_docs)
    torch.cuda.synchronize()
    assert torch.equal(_rows_whole(got), _rows_whole(want))
    assert not _rows_whole(got)[24:].any()


@pytest.mark.parametrize("n_docs", [2_999, 5_001])
def test_stream_tiles_small_rows(card, gen, n_docs):
    # N+1 below one tile (3,000 and 5,002 cells: one tile a row) and not a
    # multiple of the tile (over 1,000-cell tiles).
    from vectorchord_bm25_tpu_torch.ops import dense_tiles, stream_kernel

    si, tables, wsrc, wq, word_ord, n_q = _stream_case(gen, n_docs=n_docs, tf_hi=15)
    lists = _port_lists(si, wsrc, wq, word_ord, n_q)
    for tile in (dense_tiles.TILE, 1000):
        old, dense_tiles.TILE = dense_tiles.TILE, tile
        try:
            _dirty_pool(n_q, si.n_docs)
            got = stream_kernel.stream_dense_accumulate(*tables, *lists, n_q, si.n_docs)
        finally:
            dense_tiles.TILE = old
        want = stream_kernel.stream_dense_accumulate_plain(*tables, *lists, n_q, si.n_docs)
        torch.cuda.synchronize()
        assert torch.equal(_rows_whole(got), _rows_whole(want))


def _topk_cases(n=(1 << 17) + 777):
    gen = np.random.default_rng(11)
    ties = np.zeros((6, n + 1), dtype=np.float32)
    ties[:, :n] = gen.choice(np.array([0, 0, 1, 2, 3], dtype=np.float32), size=(6, n))
    tail = np.zeros((2, n + 1), dtype=np.float32)
    tail[:, :n] = 0.5
    tail[0, n - 3 :] = 0.0
    tail[0, n - 5] = 9.0
    tail[1, n - 1] = 7.5
    few = np.zeros((3, n + 1), dtype=np.float32)
    few[0, 11] = 2.0
    few[1, 5] = 1.0
    few[1, n - 1] = 3.0
    few[2, n] = 100.0  # the pad column never wins
    small = np.zeros((5, 5001), dtype=np.float32)
    small[:, :5000] = gen.choice(np.array([0, 1, 2], dtype=np.float32), size=(5, 5000))
    dense = (gen.random((4, n + 1), dtype=np.float32) - 0.2).astype(np.float32)
    return [(ties, 10, n), (tail, 4, n), (few, 8, n), (small, 7, 5000), (dense, 16, n)]


@pytest.mark.parametrize("case", range(5))
def test_dense_topk_matches_plain(card, case):
    from vectorchord_bm25_tpu_torch.ops import topk

    acc_np, k, n_docs = _topk_cases()[case]
    acc = topk.new_accumulator(acc_np.shape[0], acc_np.shape[1] - 1, card)
    acc.copy_(torch.from_numpy(acc_np))
    before = topk.LAUNCHES
    s, i = topk.dense_topk(acc, k, n_docs)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    ps, pi = topk.dense_topk_plain(acc, k, n_docs)
    assert torch.equal(s, ps) and torch.equal(i, pi)
    cs, ci = topk.dense_topk(torch.from_numpy(acc_np), k, n_docs)
    assert torch.equal(s.cpu(), cs) and torch.equal(i.cpu(), ci)


def test_dense_topk_rejects_bad_inputs(card):
    from vectorchord_bm25_tpu_torch.ops import topk

    with pytest.raises(TypeError):
        topk.dense_topk(torch.zeros((2, 4096), dtype=torch.float64, device=card), 2, 4095)
    # Rows that do not start 16-B aligned (odd contiguous width).
    with pytest.raises(ValueError, match="aligned"):
        topk.dense_topk(torch.zeros((2, 4097), device=card), 2, 4096)
    with pytest.raises(ValueError, match="aligned"):
        topk.dense_topk(torch.zeros((8, 4096), device=card).t(), 2, 7)



def _s2_design_case(name):
    """The cases csrc/dense_topk.cu's design must keep: (acc, k, n_docs)."""
    r = np.random.default_rng(31)
    n = (1 << 17) + 777
    flat = name.endswith("flat")
    if name.startswith("pads"):
        n = 5000 if flat else n
        acc = np.zeros((6, n + 1), dtype=np.float32)
        for row in range(1, 6):
            acc[row, r.choice(n, size=2 * row, replace=False)] = 1.5
        acc[5, : n : 3] = -1.0
        return acc, 16, n
    if name == "ties_at_kth_block_max":
        acc = np.zeros((3, n + 1), dtype=np.float32)
        for row in range(3):
            for b in r.choice(n // 1024, size=24, replace=False):
                acc[row, b * 1024 + r.choice(1024, size=3, replace=False)] = 2.0
        return acc, 16, n
    if name == "ties_overflow_shared_memory":
        # About 3,300 docs tie at the threshold: more than the 2,048 keys
        # a block keeps, so the kernel re-reads the row to select.
        acc = np.zeros((2, n + 1), dtype=np.float32)
        acc[:, :n] = (r.random((2, n)) < 0.2).astype(np.float32)
        return acc, 16, n
    if name.startswith("nan_and_negative_zero"):
        n = 6000 if flat else n
        acc = np.zeros((3, n + 1), dtype=np.float32)
        acc[:, :n] = r.random((3, n), dtype=np.float32) - 0.6
        acc[:, r.choice(n, size=n // 5, replace=False)] = np.nan
        acc[:, r.choice(n, size=n // 5, replace=False)] = -0.0
        acc[2, :n] = np.where(acc[2, :n] > 0, np.nan, acc[2, :n])
        acc[2, 17] = 3.0
        return acc, 16, n
    if name == "tail_past_n_docs":
        acc = np.zeros((3, n + 700), dtype=np.float32)
        acc[:, n - 300 : n] = r.random((3, 300), dtype=np.float32) * 4
        acc[1, n:] = 50.0
        return acc, 16, n
    k, n, dens = {
        "k_above_32_hierarchical": (40, n, 0.05),
        "k_above_32_flat": (100, 9000, 0.05),
        "k_above_1024_hierarchical": (1100, 2 * 1100 * 1024 + 5, 0.01),
        "k_above_2048_flat": (5000, 20000, 0.3),
        "k_above_2048_pads_flat": (5000, 20000, 0.15),
    }[name]
    acc = np.zeros((2, n + 1), dtype=np.float32)
    acc[:, :n] = np.where(r.random((2, n)) < dens, r.random((2, n), dtype=np.float32), 0)
    return acc, k, n


S2_DESIGN_CASES = [
    "pads_hierarchical", "pads_flat", "ties_at_kth_block_max",
    "ties_overflow_shared_memory", "nan_and_negative_zero_hierarchical",
    "nan_and_negative_zero_flat", "tail_past_n_docs", "k_above_32_hierarchical",
    "k_above_32_flat", "k_above_1024_hierarchical", "k_above_2048_flat",
    "k_above_2048_pads_flat",
]


@pytest.mark.parametrize("case", S2_DESIGN_CASES)
def test_dense_topk_design_cases_match_plain(card, case):
    from vectorchord_bm25_tpu_torch.ops import topk

    acc_np, k, n_docs = _s2_design_case(case)
    assert topk._hierarchical(acc_np.shape[1], k, n_docs, 1024) == ("flat" not in case)
    acc = topk.new_accumulator(acc_np.shape[0], acc_np.shape[1] - 1, card)
    acc.copy_(torch.from_numpy(acc_np))
    before = topk.LAUNCHES
    s, i = topk.dense_topk(acc, k, n_docs)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    ps, pi = topk.dense_topk_plain(acc, k, n_docs)
    # Scores and every id, the pads' included.
    assert torch.equal(s, ps) and torch.equal(i, pi)

def test_stream_engine_on_card_equals_cpu(card, gen):
    from vectorchord_bm25_tpu.index.sealed import build_sealed_segment
    from vectorchord_bm25_tpu.index.stream import build_stream_index
    from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    seg = build_sealed_segment(make_docs(gen, 3000, vocab=40))
    si = build_stream_index(seg)
    on_card = StreamEngine(seg, stream=si, device=card)
    on_cpu = StreamEngine(seg, stream=si, device="cpu")
    deleted = gen.random(3000) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(3000) < 0.7
    queries = [
        Query.from_int_ids(gen.integers(0, 40, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for kw in ({}, {"filter_mask": fmask}):
        s1, t1 = stream_kernel.LAUNCHES, topk.LAUNCHES
        got = on_card.search(queries, 10, **kw)
        assert stream_kernel.LAUNCHES > s1 and topk.LAUNCHES > t1
        want = on_cpu.search(queries, 10, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()


def test_facade_default_engine_with_growing_on_card(card, gen):
    from vectorchord_bm25_tpu_torch import Bm25Index
    from vectorchord_bm25_tpu_torch.ops import stream_kernel

    docs = make_docs(gen, 2000, vocab=200)
    queries = [
        Query.from_int_ids(gen.integers(0, 200, size=int(n)).tolist())
        for n in gen.integers(1, 6, size=64)
    ]
    seed = bytes(16)
    gpu = Bm25Index.build(docs, seed=seed, device=card)
    cpu = Bm25Index.build(docs, seed=seed, device="cpu")
    for i, doc in enumerate(make_docs(gen, 50, vocab=200)):
        gpu.insert(doc, 10_000 + i)
        cpu.insert(doc, 10_000 + i)
    before = stream_kernel.LAUNCHES
    got = gpu.search_batch(queries, 10)
    assert stream_kernel.LAUNCHES > before
    assert gpu.growing.device_engine().dev_words.is_cuda

    def hits(results):
        return [[(h.score, h.payload) for h in row] for row in results]

    assert hits(got) == hits(cpu.search_batch(queries, 10))


# --- the sparse and MaxScore kernels: S3 stream_sparse_decode, S4
# sparse_combine, S5 stream_rescore


def _window_matrix(gen, si, wsrc, n_q=16):
    """The case's windows dealt into a [n_q, P] matrix (the sparse path's
    layout), with pad windows W at random places."""
    live = wsrc[wsrc < si.n_windows]
    p = -(-live.size // n_q) + 8
    mat = np.full(n_q * p, si.n_windows, dtype=np.int32)
    mat[np.sort(gen.choice(mat.size, size=live.size, replace=False))] = live
    return mat.reshape(n_q, p)


@pytest.mark.parametrize("tf_hi", [1, 15, 400])
def test_sparse_decode_matches_plain(card, gen, tf_hi):
    from vectorchord_bm25_tpu_torch.ops import stream_sparse

    si, tables, wsrc, _, _, _ = _stream_case(gen, tf_hi=tf_hi)
    mat = torch.from_numpy(_window_matrix(gen, si, wsrc)).cuda()
    before = stream_sparse.DECODE_LAUNCHES
    doc, sc = stream_sparse.stream_sparse_decode(*tables, mat, si.n_docs)
    torch.cuda.synchronize()
    assert stream_sparse.DECODE_LAUNCHES == before + 1
    p_doc, p_sc = stream_sparse.stream_sparse_decode_plain(*tables, mat, si.n_docs)
    assert torch.equal(doc, p_doc) and torch.equal(sc, p_sc)
    assert int((sc > 0).sum()) > 1000
    c_doc, c_sc = stream_sparse.stream_sparse_decode(
        *[t.cpu() for t in tables], mat.cpu(), si.n_docs
    )
    assert torch.equal(doc.cpu(), c_doc) and torch.equal(sc.cpu(), c_sc)


@pytest.mark.parametrize("seg_steps", [0, 1, 2, 4])
def test_sparse_combine_matches_plain(card, gen, seg_steps):
    from vectorchord_bm25_tpu_torch.ops import stream_sparse

    # Random sorted rows: runs of every length, some past 2^seg_steps, pad
    # docs (n_docs) and zero scores.
    n_docs = 3000
    df = np.sort(gen.integers(0, n_docs + 1, size=(24, 20_000)), axis=1)
    sf = gen.random(df.shape, dtype=np.float32) * 4
    sf[gen.random(df.shape) < 0.1] = 0.0
    df_t = torch.from_numpy(df.astype(np.int32)).cuda()
    sf_t = torch.from_numpy(sf).cuda()
    before = stream_sparse.COMBINE_LAUNCHES
    keys = stream_sparse.sparse_combine(df_t, sf_t, n_docs, seg_steps)
    torch.cuda.synchronize()
    assert stream_sparse.COMBINE_LAUNCHES == before + 1
    assert torch.equal(keys, stream_sparse.sparse_combine_plain(df_t, sf_t, n_docs, seg_steps))
    cpu = stream_sparse.sparse_combine(df_t.cpu(), sf_t.cpu(), n_docs, seg_steps)
    assert torch.equal(keys.cpu(), cpu)


def _segmented(si, query_terms, prefix=None):
    """The sparse path's [Q, P] window matrix and its segments (host int32
    [Q, S+1]): each query's term spans in term order, a span's windows in
    id order (``prefix(t)``: a subset of a term's windows), padded with W."""
    tws = si.token_w_start
    rows, cnts = [], []
    for terms in query_terms:
        spans = [np.sort(prefix(t)) if prefix else np.arange(tws[t], tws[t + 1]) for t in terms]
        rows.append(np.concatenate(spans) if spans else np.zeros(0, np.int64))
        cnts.append([s.size for s in spans])
    mat = np.full((len(rows), max(8, max(r.size for r in rows))), si.n_windows, np.int32)
    for i, r in enumerate(rows):
        mat[i, : r.size] = r
    seg_off = np.zeros((len(rows), max(1, max(map(len, cnts))) + 1), np.int32)
    for i, c in enumerate(cnts):
        off = np.cumsum([0] + c)
        seg_off[i, : off.size] = off
        seg_off[i, off.size:] = off[-1]
    return mat, torch.from_numpy(seg_off)


@pytest.mark.parametrize("k", [16, 5000])
def test_sparse_topk_on_index_windows_matches_cpu(card, gen, k):
    # SP-stream on the case's query spans (segments from the planning) ==
    # the CPU path, pad ids included; one launch a call.
    from vectorchord_bm25_tpu_torch.ops import stream_sparse

    si, tables, _, _, _, _ = _stream_case(gen, tf_hi=15)
    terms = [gen.integers(0, si.n_tokens, size=int(gen.integers(1, 6))).tolist() for _ in range(8)]
    mat, seg_off = _segmented(si, terms + [[3, 3, 7], []])
    mt = max(len(x) for x in terms + [[3, 3, 7]])
    before = stream_sparse.MERGE_LAUNCHES
    got = stream_sparse.stream_sparse_topk(
        *tables, torch.from_numpy(mat).cuda(), k, si.n_docs, int(mt - 1).bit_length(), seg_off
    )
    torch.cuda.synchronize()
    assert stream_sparse.MERGE_LAUNCHES == before + 1
    want = stream_sparse.stream_sparse_topk(
        *[t.cpu() for t in tables], torch.from_numpy(mat), k, si.n_docs,
        int(mt - 1).bit_length(), seg_off,
    )
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize(
    "case",
    ["many_segments", "long_row", "deepest_pool", "all_deleted", "maxscore_prefix",
     "over_lanes"],
)
def test_sparse_merge_design_cases_equal_plain(card, gen, case):
    # SP-stream's paths past the main one: segment cursors in device memory
    # (S > 256), a row's window bases read from device memory (> 8,192
    # windows), k = 16,384 (the pool cap) with pads, rows with no
    # candidate, impact-ordered prefixes put in doc order, rows of more
    # segments than a tile has lanes (one-doc tiles summed in chunks).
    from vectorchord_bm25_tpu_torch.ops import stream_sparse

    si, tables, _, _, _, _ = _stream_case(gen, tf_hi=15)
    prefix, k = None, 64
    terms = [gen.integers(0, si.n_tokens, size=int(gen.integers(1, 6))).tolist() for _ in range(6)]
    if case == "many_segments":
        terms += [gen.integers(0, si.n_tokens, size=300).tolist()]
    elif case == "long_row":
        terms += [[0] * 60]  # term 0 holds every doc: 60 x 157 windows
    elif case == "deepest_pool":
        k = 16384
    elif case == "over_lanes":
        one = np.flatnonzero(np.diff(si.token_w_start) == 1)[:2].tolist()
        terms += [[0] * 2049, one * 1100, [one[0]] * 4097 + [0]]
        k = 2048
    elif case == "all_deleted":
        tables = list(tables)
        tables[1] = torch.full_like(tables[1], float("inf"))
    else:
        imp = np.lexsort((-si.w_maximp, si.w_token))
        tws = si.token_w_start

        def prefix(t):
            span = imp[tws[t]:tws[t + 1]]
            return span[: max(1, span.size // 3)]

    mat, seg_off = _segmented(si, terms, prefix)
    seg_steps = int(max(len(x) for x in terms) - 1).bit_length()
    if case == "many_segments":
        assert seg_off.shape[1] - 1 > 256
    if case == "long_row":
        assert int(seg_off[:, -1].max()) > 8192
    if case == "over_lanes":
        assert seg_off.shape[1] - 1 == 4098
    args = (*tables, torch.from_numpy(mat).cuda(), k, si.n_docs, seg_steps, seg_off)
    before = stream_sparse.MERGE_LAUNCHES
    got = stream_sparse.stream_sparse_topk(*args)
    want = stream_sparse.stream_sparse_topk_plain(*args)
    torch.cuda.synchronize()
    assert stream_sparse.MERGE_LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "all_deleted":
        assert not torch.isfinite(got[0]).any()
    with pytest.raises(TypeError, match="seg_off"):
        stream_sparse.stream_sparse_topk(*args[:10])
    with pytest.raises(ValueError, match="CPU"):
        stream_sparse.stream_sparse_topk(*args[:10], seg_off.cuda())


def _rescore_case(gen, si, n_q=24, c=64, tmax=4):
    tws = si.token_w_start
    t_lo = np.zeros((n_q, tmax), np.int32)
    t_hi = np.zeros((n_q, tmax), np.int32)
    cand = np.full((n_q, c), si.n_docs, np.int32)
    for q in range(n_q):
        terms = gen.integers(0, si.n_tokens, size=int(gen.integers(1, tmax + 1)))
        t_lo[q, : terms.size], t_hi[q, : terms.size] = tws[terms], tws[terms + 1]
        docs = np.concatenate(
            [si.decode_window(int(tws[t]))[0] for t in terms]
            + [gen.integers(0, si.n_docs, size=16)]
        )
        pick = np.unique(gen.choice(docs, size=c - 8))
        cand[q, : pick.size] = pick
    cand.sort(axis=1)
    return [torch.from_numpy(x).cuda() for x in (cand, t_lo, t_hi)]


@pytest.mark.parametrize(
    "case", ["sorted", "unsorted", "all_pad_rows", "neg_inf_rows", "c16384", "c_past_smem"]
)
def test_stream_rescore_matches_plain(card, gen, case):
    # S5's two entries on one kernel: stream_rescore (the [Q, C] scores) and
    # rescore_topk (scores and selection in one launch), each torch.equal to
    # its plain version on the card and to the CPU, ids of the -inf slots and
    # of the pads past C included.  16,384 candidates keep their keys in
    # shared memory; 30,000 take the scratch row (stream_rescore.SMEM_KEYS).
    from vectorchord_bm25_tpu_torch.ops import stream_rescore

    si, tables, _, _, _, _ = _stream_case(gen, tf_hi=400)
    c = {"c16384": 16384, "c_past_smem": 30000}.get(case, 64)
    n_q = 24 if c == 64 else 4
    cand, t_lo, t_hi = _rescore_case(gen, si, n_q=n_q, c=c)
    if case == "unsorted":
        cand = cand[:, torch.randperm(c, device=card)].contiguous()
    elif case == "all_pad_rows":
        cand[::3] = si.n_docs
    elif case == "neg_inf_rows":
        t_hi[::2] = t_lo[::2]  # no term has a window: every score is -inf
    elif c > 64:
        # Every doc a candidate somewhere: most score, many tie.
        cand = torch.from_numpy(
            np.sort(gen.integers(0, si.n_docs, size=(n_q, c)), axis=1).astype(np.int32)
        ).to(card)
    cpu_args = [t.cpu() for t in (*tables, cand, t_lo, t_hi)]
    before = stream_rescore.LAUNCHES
    got = stream_rescore.stream_rescore(*tables, cand, t_lo, t_hi, si.n_docs)
    torch.cuda.synchronize()
    assert stream_rescore.LAUNCHES == before + 1
    want = stream_rescore.stream_rescore_plain(*tables, cand, t_lo, t_hi, si.n_docs)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), stream_rescore.stream_rescore(*cpu_args, si.n_docs))
    if case not in ("all_pad_rows", "neg_inf_rows"):
        assert int(torch.isfinite(got).sum()) > 100
    for k in (1, 10, 128, c + 5):
        before = stream_rescore.LAUNCHES
        s, i = stream_rescore.rescore_topk(*tables, cand, t_lo, t_hi, k, si.n_docs)
        torch.cuda.synchronize()
        assert stream_rescore.LAUNCHES == before + 1
        w_s, w_i = stream_rescore.rescore_topk_plain(*tables, cand, t_lo, t_hi, k, si.n_docs)
        assert torch.equal(s, w_s) and torch.equal(i, w_i), k
        c_s, c_i = stream_rescore.rescore_topk(*cpu_args, k, si.n_docs)
        assert torch.equal(s.cpu(), c_s) and torch.equal(i.cpu(), c_i), k
        if case == "neg_inf_rows":
            assert not torch.isfinite(s[::2]).any() and not i[::2].any()


def test_rescore_keys_beside_static_shared_memory_launch(card):
    # S5's first launch in a process with keys that fit 48 KB of shared
    # memory only without the kernel's static part (C = 4,096, k = 1,000:
    # 40,960 B) must raise the dynamic limit itself; a fresh process, since
    # an earlier launch with more keys leaves the limit raised.
    import os
    import subprocess
    import sys

    code = """
import numpy as np, torch
from vectorchord_bm25_tpu_torch import build_sealed_segment_from_postings
from vectorchord_bm25_tpu_torch.data.synth import synth_corpus_postings
from vectorchord_bm25_tpu_torch.ops import stream_rescore as sr
from vectorchord_bm25_tpu_torch.search.stream import StreamEngine
n = 20000
keys, docs, tfs, _ = synth_corpus_postings(n, 500, 20, seed=1)
eng = StreamEngine(build_sealed_segment_from_postings(keys, docs, tfs, n, doc_grouped=True),
                   device="cuda")
tabs = (eng.dev_words, eng._s1_eff(None), *eng._window_tables())
tws = eng.stream.token_w_start
rng = np.random.default_rng(0)
cand = torch.from_numpy(np.sort(rng.integers(0, n + 1, (4, 4096)), axis=1).astype(np.int32)).cuda()
t = rng.integers(0, len(tws) - 1, (4, 2))
lo, hi = (torch.from_numpy(tws[x].astype(np.int32)).cuda() for x in (t, t + 1))
got = sr.rescore_topk(*tabs, cand, lo, hi, 1000, n)
want = sr.rescore_topk_plain(*tabs, cand, lo, hi, 1000, n)
assert sr.select_room(4096, 1000) * 8 <= 48 * 1024
assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=600)


def _in_fresh_process(code):
    """Runs ``code`` in a new Python process from the repo's root: a launch
    there is the first of its kernel, with the dynamic shared-memory limit
    at its default (an earlier launch that needed more leaves it raised)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=600)


# The (term, range) group CSR of ``_round_csr`` for a fresh process, on the
# card: tts, tr_range, tr_start, tr_ub and q_tid over R ranges.
_FRESH_ROUND_CSR = """
import numpy as np, torch
from vectorchord_bm25_tpu_torch.ops import blockmax_round as br
gen = np.random.default_rng(7)
vocab, lmax, n_q, t = 24, 2048, 33, 4
counts = gen.integers(0, 600, size=vocab)
tts = np.zeros(vocab + 2, np.int32)
tts[1 : vocab + 1] = np.cumsum(counts)
tts[vocab + 1] = tts[vocab]
m = int(tts[vocab])
tr_range = np.full(m + 1, 2**31 - 1, np.int32)
for v in range(vocab):
    tr_range[tts[v] : tts[v + 1]] = np.sort(gen.choice(R, size=counts[v], replace=False))
tr_start = np.zeros(m + 2, np.int32)
tr_start[1 : m + 1] = np.cumsum(gen.integers(1, 9, size=m))
tr_start[m + 1] = tr_start[m]
tr_ub = np.append(gen.choice(np.float32([0.5, 1.25, 3.0]), size=m), np.float32(0)).astype(np.float32)
q_tid = gen.integers(0, vocab, size=(n_q, t)).astype(np.int32)
q_tid[0] = vocab
tts, tr_range, tr_start, tr_ub, q_tid = (
    torch.from_numpy(x).cuda() for x in (tts, tr_range, tr_start, tr_ub, q_tid)
)
"""


def test_round_select_beside_static_shared_memory_launch(card):
    # B1-select's first launch at R = 11,600 with its default chunk: the row
    # and the keys (47,848 B) fit 48 KB only without the kernel's 2,448 B of
    # static shared memory (ptxas), so the launch must raise the dynamic limit.
    _in_fresh_process("R = 11600\n" + _FRESH_ROUND_CSR + """
C = min(256, max(32, R // 64))  # the engine's default chunk
assert 4 * R + 8 * C <= 49152 < 4 * R + 8 * C + 2448  # 2,448 B static
ub = br.range_bounds_plain(tts, tr_range, tr_ub, q_tid, n_ranges=R, lmax=lmax)
ub_plain = ub.clone()
topk_s = torch.full((n_q, 16), float("-inf"), device="cuda")
topk_s[1::2, -1] = 2.0
before = br.SELECT_LAUNCHES
got = br.round_select(ub, topk_s, tr_range, tr_start, tts, q_tid, chunk=C, lmax=lmax)
want = br.round_select_plain(ub_plain, topk_s, tr_range, tr_start, tts, q_tid, chunk=C, lmax=lmax)
torch.cuda.synchronize()
assert br.SELECT_LAUNCHES == before + 1
assert all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(ub, ub_plain)
assert int(got[3]) == 1 and (got[2] > 0).any()
""")


def test_range_bounds_beside_static_shared_memory_launch(card):
    # B1-bounds' first launch at R = 12,288: its row (49,152 B) fits 48 KB
    # only without the kernel's 32 B of static shared memory.
    _in_fresh_process("R = 12288\n" + _FRESH_ROUND_CSR + """
assert 4 * R <= 49152 < 4 * R + 32  # 32 B static
before = br.BOUNDS_LAUNCHES
got = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=R, lmax=lmax)
want = br.range_bounds_plain(tts, tr_range, tr_ub, q_tid, n_ranges=R, lmax=lmax)
torch.cuda.synchronize()
assert br.BOUNDS_LAUNCHES == before + 1
assert torch.equal(got, want) and (got > 0).any()
""")


def test_dense_tiles_beside_static_shared_memory_launch(card):
    # S1's first launch with TILE raised to 12,288 cells on rows of 12,000:
    # one tile of 48,000 B fits 48 KB only without the walk's 6,176 B of
    # static Scratch (csrc/dense_tiles.cuh).
    _in_fresh_process("""
import numpy as np, torch
from vectorchord_bm25_tpu_torch import build_sealed_segment_from_postings
from vectorchord_bm25_tpu_torch.data.synth import synth_corpus_postings
from vectorchord_bm25_tpu_torch.ops import dense_tiles, stream_kernel
from vectorchord_bm25_tpu_torch.search.stream import StreamEngine
n = 11999
dense_tiles.TILE = 12288
width, n_tiles = dense_tiles.tile_split((n + 1 + 3) & ~3, dense_tiles.TILE)
assert n_tiles == 1 and 4 * width <= 49152 < 4 * width + 6176  # 6,176 B static
keys, docs, tfs, _ = synth_corpus_postings(n, 500, 20, seed=1)
eng = StreamEngine(build_sealed_segment_from_postings(keys, docs, tfs, n, doc_grouped=True),
                   device="cuda")
tabs = (eng.dev_words, eng._s1_eff(None), *eng._window_tables())
tws = eng.stream.token_w_start
rng = np.random.default_rng(0)
wsrc, q_start, w_ord = [], [0], []
for q in range(16):
    for o, t in enumerate(rng.integers(0, len(tws) - 1, size=3)):
        span = np.arange(tws[t], tws[t + 1])
        wsrc.append(span)
        w_ord.append(np.full(span.size, o))
    q_start.append(sum(x.size for x in wsrc))
lists = [torch.from_numpy(np.asarray(x, dtype=np.int32)).cuda()
         for x in (np.concatenate(wsrc), q_start, np.concatenate(w_ord))]
before = stream_kernel.LAUNCHES
got = stream_kernel.stream_dense_accumulate(*tabs, *lists, 16, n)
want = stream_kernel.stream_dense_accumulate_plain(*tabs, *lists, 16, n)
torch.cuda.synchronize()
assert stream_kernel.LAUNCHES == before + 1
assert torch.equal(got, want) and int((got > 0).sum()) > 1000
""")


@pytest.mark.parametrize("strategy", ["sparse", "maxscore", "auto"])
def test_stream_strategies_on_card_equal_cpu(card, gen, strategy, monkeypatch):
    from vectorchord_bm25_tpu.index.sealed import build_sealed_segment
    from vectorchord_bm25_tpu.index.stream import build_stream_index
    from vectorchord_bm25_tpu_torch.ops import stream_rescore, stream_sparse
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    # 'auto' leaves the dense path at SPARSE_MIN_DOCS; routing everything
    # with enough windows to MaxScore exercises both of its branches.
    monkeypatch.setattr(StreamEngine, "SPARSE_MIN_DOCS", 1000)
    monkeypatch.setattr(StreamEngine, "MS_ROUTE_MIN_WINDOWS", 4)
    seg = build_sealed_segment(make_docs(gen, 3000, vocab=40))
    si = build_stream_index(seg)
    on_card = StreamEngine(seg, stream=si, strategy=strategy, device=card)
    on_cpu = StreamEngine(seg, stream=si, strategy=strategy, device="cpu")
    deleted = gen.random(3000) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(3000) < 0.7
    queries = [
        Query.from_int_ids(gen.integers(0, 40, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for kw in ({}, {"filter_mask": fmask}):
        s3, s4 = stream_sparse.DECODE_LAUNCHES, stream_sparse.COMBINE_LAUNCHES
        sp, s5 = stream_sparse.MERGE_LAUNCHES, stream_rescore.LAUNCHES
        got = on_card.search(queries, 10, **kw)
        # SP-stream, not the parent's S3 and S4.
        assert stream_sparse.MERGE_LAUNCHES > sp
        assert (stream_sparse.DECODE_LAUNCHES, stream_sparse.COMBINE_LAUNCHES) == (s3, s4)
        if strategy != "auto":
            assert (stream_rescore.LAUNCHES > s5) == (strategy == "maxscore")
        want = on_cpu.search(queries, 10, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert on_card.last_ms_stats == on_cpu.last_ms_stats
    assert on_card.memory_report() == on_cpu.memory_report()


# --- the rest of the Block-Max engine: P1 on bf16, P1-tf, the B2 sweep


def _recorded(monkeypatch, name):
    """Record every call the Block-Max engine makes to ``name`` (imported
    into search/blockmax.py) while passing it through."""
    from vectorchord_bm25_tpu_torch.search import blockmax

    calls, real = [], getattr(blockmax, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(blockmax, name, record)
    return calls


def test_bf16_kernel_matches_plain(card, gen):
    p, rs = 8192, 128
    post_local = torch.from_numpy(gen.integers(0, rs, size=p).astype(np.uint8))
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32))
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(16, 4, 8)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(16, 4, 8)).astype(np.int32))
    args = [x.to(card) for x in (post_impact.to(torch.bfloat16), post_local, starts, lens)]
    before = score_kernel.BF16_LAUNCHES
    got = score_kernel.fused_range_scores(*args, rs=rs)
    torch.cuda.synchronize()
    assert score_kernel.BF16_LAUNCHES == before + 1
    want = score_kernel.fused_range_scores_plain(*args, rs=rs)
    # Colliding slots add in atomic order on both sides.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["bf16", "tf8", "tf16"])
def test_engine_modes_kernel_equal_plain_on_index_windows(card, gen, monkeypatch, mode):
    # Every call the engine makes, on its own windows: kernel == plain.
    docs = make_docs(gen, 3000, vocab=40)
    if mode == "tf16":
        from vectorchord_bm25_tpu.text.intern import Document

        docs[5] = Document(keys=docs[5].keys, values=docs[5].values * 300)
    seg = build_sealed_segment(docs)
    ri = build_range_index(seg)
    kw = {"impact_dtype": "bfloat16"} if mode == "bf16" else {"posting_mode": "tf"}
    name = "fused_range_scores" if mode == "bf16" else "tf_range_scores"
    calls = _recorded(monkeypatch, name)
    on_card = BlockMaxEngine(seg, ri, chunk=4, device=card, **kw)
    on_cpu = BlockMaxEngine(seg, ri, chunk=4, device="cpu", **kw)
    if mode != "bf16":
        want_dtype = torch.int16 if mode == "tf16" else torch.uint8
        assert on_card.dev_post_tf.dtype == want_dtype
    deleted = gen.random(3000) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    queries = [
        Query.from_int_ids(gen.integers(0, 40, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    counter = "BF16_LAUNCHES" if mode == "bf16" else "TF_LAUNCHES"
    before = getattr(score_kernel, counter)
    got = on_card.search(queries, 10)
    assert getattr(score_kernel, counter) > before
    card_calls = [c for c in calls if c[0][0].is_cuda]
    assert card_calls
    plain = getattr(score_kernel, name + "_plain")
    for args, kw_ in card_calls:
        out = getattr(score_kernel, name)(*args, **kw_)
        assert torch.equal(out, plain(*args, **kw_))
    want = on_cpu.search(queries, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()


def test_rangescan_on_card_equals_cpu_and_pruned(card, gen):
    from vectorchord_bm25_tpu_torch.ops import topk

    seg = build_sealed_segment(make_docs(gen, 3000, vocab=40))
    ri = build_range_index(seg)
    on_card = BlockMaxEngine(seg, ri, chunk=4, device=card)
    on_cpu = BlockMaxEngine(seg, ri, chunk=4, device="cpu")
    fmask = gen.random(3000) < 0.7
    queries = [
        Query.from_int_ids(gen.integers(0, 40, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for kw in ({}, {"filter_mask": fmask}):
        p1, s2 = score_kernel.LAUNCHES, topk.LAUNCHES
        got = on_card.search_rangescan_async(queries, 10, **kw)()
        assert score_kernel.LAUNCHES > p1 and topk.LAUNCHES == s2 + 1
        want = on_cpu.search_rangescan_async(queries, 10, **kw)()
        pruned = on_card.search(queries, 10, **kw)
        for g, w, p in zip(got, want, pruned):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


def test_strided_output_matches_dense(card, gen):
    p, rs, q, t, c = 4096, 64, 6, 3, 5
    post_local = torch.from_numpy(gen.integers(0, rs, size=p).astype(np.uint8)).to(card)
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32)).to(card)
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(q, t, c)).astype(np.int32)).to(card)
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(q, t, c)).astype(np.int32)).to(card)
    dense = score_kernel.fused_range_scores(post_impact, post_local, starts, lens, rs=rs)
    wide = torch.full((q, 3 * c * rs + 4), -1.0, device=card)
    view = wide[:, c * rs : 2 * c * rs]
    assert score_kernel.fused_range_scores(
        post_impact, post_local, starts, lens, rs=rs, out=view
    ) is view
    torch.cuda.synchronize()
    torch.testing.assert_close(view.reshape(q, c, rs), dense, rtol=1e-5, atol=1e-6)
    assert bool((wide[:, : c * rs] == -1).all()) and bool((wide[:, 2 * c * rs :] == -1).all())



def _p1_unique_windows(gen, q, t, c, rs, slot_hi, card, p=8192):
    """Windows with unique slots (as on index data) from [0, slot_hi)."""
    loc = np.concatenate([gen.permutation(slot_hi)[:rs] for _ in range(p // rs)]).astype(np.uint8)
    imp = (gen.random(loc.size) * 8).astype(np.float32)
    starts = (gen.integers(0, loc.size // rs - 1, (q, t, c)) * rs).astype(np.int32)
    lens = gen.integers(0, rs + 1, (q, t, c)).astype(np.int32)
    lens[gen.random((q, t, c)) < 0.5] = 0
    return [torch.from_numpy(x).to(card) for x in (imp, loc, starts, lens)]


@pytest.mark.parametrize(
    "case", ["all_inactive_queries", "row_stride_wider_than_c_rs", "bf16_impacts",
             "slots_past_rs", "unaligned_output", "many_terms", "no_terms"],
)
def test_p1_design_cases_equal_plain(card, gen, case):
    # Index-like windows (unique slots a window), so every case is equal
    # bit for bit, not to a tolerance.
    rs = 64 if case == "slots_past_rs" else 128
    t = {"many_terms": 37, "no_terms": 0}.get(case, 4)
    imp, loc, starts, lens = _p1_unique_windows(
        gen, 64, t, 32, rs, 256 if case == "slots_past_rs" else rs, card
    )
    if case == "all_inactive_queries":
        lens[::2] = 0
    if case == "bf16_impacts":
        imp = imp.to(torch.bfloat16)
    q, _, c = starts.shape
    want = score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs)
    if case in ("row_stride_wider_than_c_rs", "unaligned_output"):
        off = 132 if case == "row_stride_wider_than_c_rs" else 1
        wide = torch.full((q, c * rs + 2 * off + 4), -1.0, device=card)
        view = wide[:, off : off + c * rs]
        got = score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs, out=view)
        torch.cuda.synchronize()
        assert got is view
        got = got.reshape(q, c, rs)
        assert bool((wide[:, :off] == -1).all()) and bool((wide[:, off + c * rs :] == -1).all())
    else:
        got = score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs)
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "all_inactive_queries":
        assert not got[::2].any() and got[1::2].any()

@pytest.mark.parametrize(
    "case", ["four_terms", "all_inactive_queries", "many_terms", "no_terms", "u16_tf",
             "slots_past_rs", "b1_fieldnorm_zero"],
)
def test_p1_tf_design_cases_equal_plain(card, gen, case):
    # P1-tf on P1's walk, on index-like windows: equal bit for bit.  With
    # b = 1, s1_table[0] is 0; every window is full there, so no lane past
    # a window's length (which the plain version scores as 0/0) exists.
    rs = 64 if case == "slots_past_rs" else 128
    t = {"many_terms": 37, "no_terms": 0}.get(case, 4)
    q, c, n_docs = 64, 32, 5000
    _, loc, starts, lens = _p1_unique_windows(
        gen, q, t, c, rs, 256 if case == "slots_past_rs" else rs, card
    )
    p = loc.numel()
    if case == "u16_tf":
        tf = gen.integers(1, 1 << 16, p).astype(np.uint16).view(np.int16)
    else:
        tf = gen.integers(1, 256, p).astype(np.uint8)
    fn = gen.integers(0, 256, n_docs + 1).astype(np.uint8)
    s1 = (gen.random(256) * 3 + 0.5).astype(np.float32)
    if case == "b1_fieldnorm_zero":
        s1[0] = 0.0
        fn[::3] = 0
        lens.fill_(rs)
    s0 = (gen.random((q, t)) * 4).astype(np.float32)
    cand = gen.integers(0, n_docs // rs + 1, (q, c)).astype(np.int32)
    if case == "all_inactive_queries":
        lens[::2] = 0
    args = [torch.from_numpy(x).to(card) for x in (tf, fn, s1, s0, cand)]
    args = (args[0], loc, *args[1:], starts, lens)
    before = score_kernel.TF_LAUNCHES
    got = score_kernel.tf_range_scores(*args, rs=rs, n_docs=n_docs)
    torch.cuda.synchronize()
    assert score_kernel.TF_LAUNCHES == before + 1
    want = score_kernel.tf_range_scores_plain(*args, rs=rs, n_docs=n_docs)
    assert not want.isnan().any()
    assert torch.equal(got, want)
    if case == "all_inactive_queries":
        assert not got[::2].any() and got[1::2].any()


def _e3_index(gen, n_docs, rs, density, full=False):
    """A compact range index as index/ranges.py lays it out: per term, its
    (term, range) groups in range order, each with distinct ascending
    locals below rs; ``full``: every group holds all docs of its range.
    Returns the posting streams and group tables (pad slot M appended) and
    the per-term group CSR."""
    n_ranges = -(-n_docs // rs)
    imp, loc, trr, trs, tts = [], [], [], [], [0]
    for dens in density:
        for r in range(n_ranges):
            width = min(rs, n_docs - r * rs)
            if gen.random() >= dens:
                continue
            n = width if full else int(gen.integers(1, min(3, width) + 1))
            if not full and gen.random() < 0.2:
                n = int(gen.integers(1, width + 1))
            trr.append(r)
            trs.append(len(loc))
            loc.extend(np.sort(gen.choice(width, n, replace=False)).tolist())
            imp.extend((gen.random(n) * 8).tolist())
        tts.append(len(trr))
    m = len(trr)
    trr.append(2**31 - 1)
    trs += [len(loc), len(loc)]
    streams = (
        np.asarray(imp + [0.0] * rs, np.float32), np.asarray(loc + [0] * rs, np.uint8),
        np.asarray(trr, np.int32), np.asarray(trs, np.int32),
    )
    return streams, np.asarray(tts), m


def _e3_rows(queries, tts, m, width=None):
    """The planning's [q, G] matrices: each query's terms in order, a term's
    groups in range order with its ordinal, then pads (M, -1)."""
    rows = []
    for terms in queries:
        ids = [g for tok in terms for g in range(tts[tok], tts[tok + 1])]
        ords = [o for o, tok in enumerate(terms) for _ in range(tts[tok], tts[tok + 1])]
        rows.append((ids, ords))
    g = width or max(8, max(len(ids) for ids, _ in rows))
    grp_ids = np.full((len(rows), g), m, np.int32)
    grp_ord = np.full((len(rows), g), -1, np.int32)
    for r, (ids, ords) in enumerate(rows):
        grp_ids[r, : len(ids)] = ids
        grp_ord[r, : len(ords)] = ords
    return grp_ids, grp_ord


@pytest.mark.parametrize(
    "case", ["groups_of_rs_postings", "row_of_only_pads", "single_query_long_row",
             "more_than_32_ordinals", "repeated_term", "bf16_impacts",
             "g_not_a_multiple_of_the_block", "rows_off_the_layout"],
)
def test_e3_design_cases_equal_plain(card, gen, case):
    # E3's one launch on planned rows (and on rows off the planning's
    # layout, which one thread a block serves): equal bit for bit.
    from vectorchord_bm25_tpu_torch.ops import exact_kernel

    n_docs, rs, vocab = 3000, 128, 12
    if case == "single_query_long_row":
        n_docs, rs = 20000, 16  # 1,252 clamped ranges: about 157 blocks, 2 tiles
    if case == "more_than_32_ordinals":
        vocab = 40
    full = case == "groups_of_rs_postings"
    density = np.full(vocab, 0.9) if case != "repeated_term" else gen.random(vocab)
    streams, tts, m = _e3_index(gen, n_docs, rs, density[: 3 if full else vocab], full)
    queries = [list(gen.integers(0, len(tts) - 1, int(gen.integers(1, 6)))) for _ in range(6)]
    queries = {
        "row_of_only_pads": [[], [0], []],
        "single_query_long_row": [list(range(vocab))],
        "more_than_32_ordinals": [list(range(37)), [1, 2]],
        "repeated_term": queries + [[3, 3, 5], [5, 3, 5]],
        "groups_of_rs_postings": [[0, 1, 2], [2]],
    }.get(case, queries)
    width = None
    if case == "g_not_a_multiple_of_the_block":
        width = max(len(range(tts[t], tts[t + 1])) * len(qr) for qr in queries for t in qr) + 301
    grp_ids, grp_ord = _e3_rows(queries, tts, m, width)
    if case == "rows_off_the_layout":
        for r in (1, 3):
            perm = gen.permutation(grp_ids.shape[1])
            grp_ids[r], grp_ord[r] = grp_ids[r, perm], grp_ord[r, perm]
    imp, loc, trr, trs = (torch.from_numpy(x).to(card) for x in streams)
    if case == "bf16_impacts":
        imp = imp.to(torch.bfloat16)
    gi, go = torch.from_numpy(grp_ids).to(card), torch.from_numpy(grp_ord).to(card)
    n_ord = int(grp_ord.max()) + 1
    in_layout = exact_kernel.compact_rows_in_layout(gi, go, trr, n_ord, n_docs, rs)
    assert bool(in_layout.all()) == (case != "rows_off_the_layout")
    if full:
        assert int((trs[1:-1] - trs[:-2]).max()) == rs
    args = (imp, loc, trr, trs, gi, go, n_ord, n_docs, rs)
    before = exact_kernel.COMPACT_LAUNCHES
    got = exact_kernel.exact_compact_accumulate(*args)
    torch.cuda.synchronize()
    assert exact_kernel.COMPACT_LAUNCHES == before + (1 if n_ord else 0)
    want = exact_kernel.exact_compact_accumulate_plain(*args)
    assert torch.equal(got, want)
    assert got.any() or case == "row_of_only_pads"


def test_launch_failure_raises(card, monkeypatch):
    # A nonzero CUDA error from the library raises; nothing falls back.
    from vectorchord_bm25_tpu_torch.ops import _build

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_build, "library", lambda: Failing())
    imp = torch.zeros(256, device=card)
    loc = torch.zeros(256, dtype=torch.uint8, device=card)
    st = torch.zeros((1, 1, 1), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        score_kernel.fused_range_scores(imp.to(torch.bfloat16), loc, st, st, rs=128)
    with pytest.raises(RuntimeError, match="launch failed"):
        score_kernel.tf_range_scores(
            loc, loc, loc, torch.zeros(256, device=card),
            torch.zeros((1, 1), device=card), st[0], st, st, rs=128, n_docs=255,
        )


def test_e3_launch_failure_raises(card, monkeypatch):
    # E3's one launch: a nonzero CUDA error raises and counts no launch.
    from vectorchord_bm25_tpu_torch.ops import _build, exact_kernel

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_build, "library", lambda: Failing())
    imp = torch.zeros(64, device=card)
    loc = torch.zeros(64, dtype=torch.uint8, device=card)
    trr = torch.tensor([0, 2**31 - 1], dtype=torch.int32, device=card)
    trs = torch.tensor([0, 3, 3], dtype=torch.int32, device=card)
    gi = torch.tensor([[0, 1]], dtype=torch.int32, device=card)
    go = torch.tensor([[0, -1]], dtype=torch.int32, device=card)
    before = exact_kernel.COMPACT_LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        exact_kernel.exact_compact_accumulate(imp, loc, trr, trs, gi, go, 1, 200, 128)
    with pytest.raises(RuntimeError, match="launch failed"):
        exact_kernel.exact_compact_accumulate(imp.bfloat16(), loc, trr, trs, gi, go, 1, 200, 128)
    assert exact_kernel.COMPACT_LAUNCHES == before


# --- the exact engine's kernels E1-E3 and the hybrid engine's routes


def _exact_recorded(monkeypatch, module, name):
    """Record every call ``module`` makes to ``name`` while passing it
    through."""
    calls, real = [], getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, record)
    return calls


def _exact_queries(gen, vocab, n=48):
    from vectorchord_bm25_tpu_torch.text.intern import Query as PortQuery

    qs = [
        PortQuery.from_int_ids(gen.integers(0, vocab, size=int(t)).tolist())
        for t in gen.integers(1, 7, size=n)
    ]
    return qs + [PortQuery.from_int_ids([3, 3, 5]), PortQuery.from_int_ids([10**6])]


@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "sparse", "compact"])
def test_exact_kernels_equal_plain_on_index_windows(card, gen, monkeypatch, mode, impact_dtype):
    # Every call the engine makes, on its own windows: kernel == plain, and
    # the card == the CPU (deletes, a filter, a repeated term, an absent one).
    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.ops import exact_kernel
    from vectorchord_bm25_tpu_torch.search import exact

    n_docs, vocab = 3000, 40
    seg = segment_from_reference(build_sealed_segment(make_docs(gen, n_docs, vocab=vocab)))
    name, counter, opts = {
        "dense": ("exact_dense_accumulate", "DENSE_LAUNCHES", {"strategy": "dense"}),
        "sparse": ("exact_sparse_topk", "MERGE_LAUNCHES", {"strategy": "sparse"}),
        "compact": ("exact_compact_accumulate", "COMPACT_LAUNCHES", {"compact": True}),
    }[mode]
    if mode == "dense" and impact_dtype == "bfloat16":
        counter = "DENSE_BF16_LAUNCHES"
    # The wrapper itself, taken before the recorder goes in where the
    # engine calls it (the sparse strategy makes one SP-exact launch).
    kernel = getattr(exact_kernel, name)
    home = exact
    calls = _exact_recorded(monkeypatch, home, name)
    opts = {**opts, "impact_dtype": impact_dtype}
    on_card = exact.ExactEngine(seg, device=card, **opts)
    on_cpu = exact.ExactEngine(seg, device="cpu", **opts)
    deleted = gen.random(n_docs) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(n_docs) < 0.7
    queries = _exact_queries(gen, vocab)
    plain = getattr(exact_kernel, name + "_plain")
    for kw in ({}, {"filter_mask": fmask}):
        for k in (10, 5000):
            del calls[:]
            before = getattr(exact_kernel, counter)
            got = on_card.search(queries, k, **kw)
            assert getattr(exact_kernel, counter) > before
            assert calls
            for args, kw_ in calls:
                out = kernel(*args, **kw_)
                want = plain(*args, **kw_)
                torch.cuda.synchronize()
                pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
                assert all(torch.equal(a, b) for a, b in pairs)
            del calls[:]
            want = on_cpu.search(queries, k, **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()


@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [10, 2048])
def test_exact_merge_equals_plain(card, gen, impact_dtype, k):
    # SP-exact on the engine's own windows and segments, with deletes, a
    # filter, a repeated and an absent term: kernel == plain, pads included.
    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.ops import exact_kernel
    from vectorchord_bm25_tpu_torch.ops.stream_sparse import ordinal_offsets
    from vectorchord_bm25_tpu_torch.search import exact

    n_docs, vocab = 3000, 40
    seg = segment_from_reference(build_sealed_segment(make_docs(gen, n_docs, vocab=vocab)))
    eng = exact.ExactEngine(seg, device=card, strategy="sparse", impact_dtype=impact_dtype)
    eng.set_deleted(gen.random(n_docs) < 0.1)
    queries = _exact_queries(gen, vocab)
    wr, wl, wh, wo, mt = eng._prepare(*looked_up(eng, queries), with_terms=True)
    fm = torch.ones(n_docs + 1, device=card)
    fm[:n_docs] = torch.from_numpy((gen.random(n_docs) < 0.7).astype(np.float32)).cuda()
    dev = eng.dev
    args = (
        dev.post_docid, dev.post_impact, dev.doc_live, fm,
        *(torch.from_numpy(x).cuda() for x in (wr, wl, wh)),
        k, n_docs, int(mt - 1).bit_length(), torch.from_numpy(ordinal_offsets(wo)),
    )
    before = exact_kernel.MERGE_LAUNCHES
    got = exact_kernel.exact_sparse_topk(*args)
    want = exact_kernel.exact_sparse_topk_plain(*args)
    torch.cuda.synchronize()
    assert exact_kernel.MERGE_LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[0]).any()
    with pytest.raises(TypeError, match="seg_off"):
        exact_kernel.exact_sparse_topk(*args[:10])


def test_exact_merge_past_a_tile_of_segments_equals_plain(card, gen):
    # SP-exact on rows of 2,049 and 4,098 term occurrences, more than a
    # tile has lanes (one-doc tiles summed in chunks of segments), with
    # deletes and a filter: kernel == plain, pads included.
    from types import SimpleNamespace

    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.ops import exact_kernel
    from vectorchord_bm25_tpu_torch.ops.stream_sparse import ordinal_offsets
    from vectorchord_bm25_tpu_torch.search import exact
    from vectorchord_bm25_tpu_torch.text.intern import Query as PortQuery

    n_docs, vocab = 3000, 40
    seg = segment_from_reference(build_sealed_segment(make_docs(gen, n_docs, vocab=vocab)))
    eng = exact.ExactEngine(seg, device=card, strategy="sparse")
    eng.set_deleted(gen.random(n_docs) < 0.1)
    keys = lambda ids, n: np.concatenate([PortQuery.from_int_ids(ids).keys] * n)  # noqa: E731
    queries = [
        SimpleNamespace(keys=keys([3], 2049)),
        SimpleNamespace(keys=keys([5, 7], 2049)),
        PortQuery.from_int_ids([3, 9]),
    ]
    wr, wl, wh, wo, mt = eng._prepare(*looked_up(eng, queries), with_terms=True)
    seg_off = ordinal_offsets(wo)
    assert seg_off.shape[1] - 1 == mt == 4098
    fm = torch.ones(n_docs + 1, device=card)
    fm[:n_docs] = torch.from_numpy((gen.random(n_docs) < 0.7).astype(np.float32)).cuda()
    dev = eng.dev
    args = (
        dev.post_docid, dev.post_impact, dev.doc_live, fm,
        *(torch.from_numpy(x).cuda() for x in (wr, wl, wh)),
        2048, n_docs, int(mt - 1).bit_length(), torch.from_numpy(seg_off),
    )
    before = exact_kernel.MERGE_LAUNCHES
    got = exact_kernel.exact_sparse_topk(*args)
    want = exact_kernel.exact_sparse_topk_plain(*args)
    torch.cuda.synchronize()
    assert exact_kernel.MERGE_LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[0]).any()


def test_exact_kernels_reject_bad_inputs(card):
    from vectorchord_bm25_tpu_torch.ops import exact_kernel

    pd = torch.zeros((3, 128), dtype=torch.int32, device=card)
    pi = torch.zeros((3, 128), device=card)
    live = torch.ones(5, device=card)
    win = torch.zeros((2, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        exact_kernel.exact_dense_accumulate(pd, pi.double(), live, win, win, win, win, 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win[:1], 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win.cpu(), win, win, win, 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win.cpu(), 1, 4)
    with pytest.raises(ValueError):
        exact_kernel.exact_dense_accumulate(
            pd, pi, live, win, win, win, win, 1, 4, filter_mask=live.cpu()
        )
    with pytest.raises(ValueError):
        exact_kernel.exact_sparse_gather(pd, pi, live, live[:4], win, win, win, 4)
    loc = torch.zeros(64, dtype=torch.uint8, device=card)
    tr = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        exact_kernel.exact_compact_accumulate(
            torch.zeros(64, device=card), loc, tr, tr, win, win, 1, 4, 128
        )


@pytest.mark.parametrize("order", ["planned", "shuffled"])
@pytest.mark.parametrize("tile", [64, 8192])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
def test_exact_tiles_equal_plain(card, gen, monkeypatch, impact_dtype, filtered, tile, order):
    # E1 on the exact planner's windows (a repeated term, an absent one, an
    # empty query: rows with no window), f32 and bf16, with the filter fused
    # into the write and without; tiles of 64 cells (windows straddle
    # tiles) and 8,192 (N+1 = 3,001 below one tile); the planned rows, and
    # each row's windows shuffled (off the layout: the one-thread path).
    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.ops import dense_tiles, exact_kernel
    from vectorchord_bm25_tpu_torch.search.exact import ExactEngine

    n_docs = 3000
    seg = segment_from_reference(build_sealed_segment(make_docs(gen, n_docs, vocab=40)))
    engine = ExactEngine(seg, device=card, strategy="dense", impact_dtype=impact_dtype)
    engine.set_deleted(gen.random(n_docs) < 0.1)
    wins = list(engine._prepare(*looked_up(engine, _exact_queries(gen, 40))))
    if order == "shuffled":
        for r in range(wins[0].shape[0]):
            perm = gen.permutation(wins[0].shape[1])
            for w in wins:
                w[r] = w[r, perm]
    dev = engine.dev
    args = (
        dev.post_docid, dev.post_impact, dev.doc_live,
        *(torch.from_numpy(w).to(card) for w in wins), int(wins[3].max()) + 1, n_docs,
    )
    in_layout = exact_kernel.dense_rows_in_layout(dev.post_docid, *args[3:8])
    assert bool(in_layout.all()) == (order == "planned")
    fm = None
    if filtered:
        fm = torch.ones(n_docs + 1, device=card)
        fm[:n_docs] = torch.from_numpy((gen.random(n_docs) < 0.6).astype(np.float32))
    monkeypatch.setattr(dense_tiles, "TILE", tile)
    counter = "DENSE_BF16_LAUNCHES" if impact_dtype == "bfloat16" else "DENSE_LAUNCHES"
    before = getattr(exact_kernel, counter)
    _dirty_pool(wins[0].shape[0], n_docs)
    got = exact_kernel.exact_dense_accumulate(*args, filter_mask=fm)
    assert getattr(exact_kernel, counter) == before + 1
    want = exact_kernel.exact_dense_accumulate_plain(*args, filter_mask=fm)
    torch.cuda.synchronize()
    assert torch.equal(_rows_whole(got), _rows_whole(want))
    assert int((got > 0).sum()) > 1000
    empty = (wins[3] < 0).all(axis=1)
    assert empty.any() and not _rows_whole(got)[torch.from_numpy(empty).to(card)].any()


def test_exact_launch_failure_raises(card, monkeypatch):
    # A nonzero CUDA error from the library raises; nothing falls back.
    from vectorchord_bm25_tpu_torch.ops import _build, exact_kernel

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(_build, "library", lambda: Failing())
    pd = torch.zeros((3, 128), dtype=torch.int32, device=card)
    pi = torch.zeros((3, 128), device=card)
    live = torch.ones(5, device=card)
    win = torch.zeros((2, 8), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        exact_kernel.exact_dense_accumulate(pd, pi, live, win, win, win, win, 1, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        exact_kernel.exact_sparse_gather(
            pd, pi.to(torch.bfloat16), live, live, win, win, win, 4
        )
    loc = torch.zeros(64, dtype=torch.uint8, device=card)
    tr = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        exact_kernel.exact_compact_accumulate(
            torch.zeros(64, device=card), loc, tr[:3], tr, win, win, 1, 4, 128
        )


def test_shared_exact_engine_aliases_blockmax(card, gen):
    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.search.exact import ExactEngine

    seg = segment_from_reference(build_sealed_segment(make_docs(gen, 2000, vocab=30)))
    bm = BlockMaxEngine(seg, device=card)
    shared = ExactEngine(seg, share=bm)
    assert shared.dev is bm.dev and shared.compact
    for name in ("dev_post_impact", "dev_post_local", "dev_tr_range", "dev_tr_start"):
        assert getattr(shared, name).data_ptr() == getattr(bm, name).data_ptr()
        assert getattr(shared, name).is_cuda
    queries = _exact_queries(gen, 30)
    got = shared.search(queries, 10)
    want = ExactEngine(seg, device="cpu", compact=True).search(queries, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("memory_mode", ["fast", "compact"])
@pytest.mark.parametrize("heavy_mode", ["auto", "pruned", "rangescan"])
def test_hybrid_on_card_equals_cpu(card, gen, heavy_mode, memory_mode):
    from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference
    from vectorchord_bm25_tpu_torch.ops import exact_kernel
    from vectorchord_bm25_tpu_torch.search.hybrid import HybridEngine

    n_docs, vocab = 3000, 600
    seg = segment_from_reference(build_sealed_segment(make_docs(gen, n_docs, vocab=vocab)))
    opts = dict(
        heavy_mode=heavy_mode, memory_mode=memory_mode, oneshot_cap=48,
        route_threshold=0.10, chunk=4,
    )
    on_card = HybridEngine(seg, device=card, **opts)
    on_cpu = HybridEngine(seg, device="cpu", **opts)
    deleted = gen.random(n_docs) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(n_docs) < 0.7
    queries = _exact_queries(gen, vocab, n=96)
    routes = np.bincount(on_card._route(*looked_up(on_card, queries))[0], minlength=3)
    assert routes.all(), routes  # every strategy group is exercised
    counter = "COMPACT_LAUNCHES" if memory_mode == "compact" else "DENSE_LAUNCHES"
    for kw in ({}, {"filter_mask": fmask}):
        p1, ex = score_kernel.LAUNCHES, getattr(exact_kernel, counter)
        got = on_card.search(queries, 10, **kw)
        assert score_kernel.LAUNCHES > p1 and getattr(exact_kernel, counter) > ex
        want = on_cpu.search(queries, 10, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()


# --- the Block-Max round outside the scoring kernel: B1-bounds, B1-select,
# B1-merge (ops/blockmax_round.py) against their plain versions


def _round_csr(gen, vocab, n_ranges, max_groups, card, bounds=(0.5, 1.25, 3.0)):
    """A random (term, range) group CSR in the engine's device layout, with
    bounds drawn from a few values (ties): (token_tr_start, tr_range,
    tr_start, tr_ub) on the card."""
    counts = gen.integers(0, max_groups + 1, size=vocab)
    counts[0], counts[1] = max_groups, 0
    tts = np.zeros(vocab + 2, dtype=np.int32)
    tts[1 : vocab + 1] = np.cumsum(counts)
    tts[vocab + 1] = tts[vocab]
    m = int(tts[vocab])
    tr_range = np.full(m + 1, np.iinfo(np.int32).max, dtype=np.int32)
    for v in range(vocab):
        tr_range[tts[v] : tts[v + 1]] = np.sort(
            gen.choice(n_ranges, size=counts[v], replace=False)
        )
    tr_start = np.zeros(m + 2, dtype=np.int32)
    tr_start[1 : m + 1] = np.cumsum(gen.integers(1, 9, size=m))
    tr_start[m + 1] = tr_start[m]
    ub = gen.choice(np.float32(bounds), size=m)
    tr_ub = np.append(ub, np.float32(0.0)).astype(np.float32)
    return [torch.from_numpy(x).to(card) for x in (tts, tr_range, tr_start, tr_ub)]


def _round_q_tid(gen, n_q, t, vocab, card):
    q_tid = gen.integers(0, vocab, size=(n_q, t)).astype(np.int32)
    q_tid[0, :] = vocab  # pads only
    for qi in range(1, n_q, 3):
        q_tid[qi, gen.integers(1, t) :] = vocab
    return torch.from_numpy(q_tid).to(card)


@pytest.mark.parametrize(
    "n_ranges,max_groups,t",
    [(37, 11, 4), (1024, 300, 4), (16384, 900, 8), (60000, 500, 4),
     (1022, 300, 40), (2048, 600, 4), (2052, 600, 8)],
)
def test_range_bounds_matches_plain(card, gen, n_ranges, max_groups, t):
    # 1,022 ranges: rows not a multiple of 4 floats; 40 terms: ten groups
    # of four, repeated terms adding to one range in order; 2,048 and
    # 2,052: either side of the block size's step; 60,000 ranges: the row
    # no longer fits shared memory.
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    vocab, lmax = 24, 1024
    tts, tr_range, _, tr_ub = _round_csr(gen, vocab, n_ranges, max_groups, card)
    q_tid = _round_q_tid(gen, 33, t, vocab, card)
    before = br.BOUNDS_LAUNCHES
    got = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax)
    torch.cuda.synchronize()
    assert br.BOUNDS_LAUNCHES == before + 1
    want = br.range_bounds_plain(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax)
    assert torch.equal(got, want) and (got > 0).any()
    cpu = br.range_bounds(
        tts.cpu(), tr_range.cpu(), tr_ub.cpu(), q_tid.cpu(), n_ranges=n_ranges, lmax=lmax
    )
    assert torch.equal(got.cpu(), cpu)
    assert br.BOUNDS_LAUNCHES == before + 1  # the CPU call launched nothing


def test_round_keeps_subnormals(card, gen):
    # A subnormal bound or score is not flushed to zero: the kernels equal
    # the plain versions on the CPU (torch's own scatter_add_ on the card
    # adds with a global atomic, which does flush, so it is no yardstick).
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    csr = _round_csr(gen, 24, 200, 60, card, bounds=(1e-41, 3e-41, 0.5))
    tts, tr_range, tr_start, tr_ub = csr
    q_tid = _round_q_tid(gen, 33, 4, 24, card)
    cpu = [x.cpu() for x in (*csr, q_tid)]
    ub = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=200, lmax=64)
    ub_cpu = br.range_bounds(cpu[0], cpu[1], cpu[3], cpu[4], n_ranges=200, lmax=64)
    assert torch.equal(ub.cpu(), ub_cpu)
    tiny = (ub_cpu > 0) & (ub_cpu < 1e-38)
    assert tiny.any()
    topk_s = torch.full((33, 4), float("-inf"))
    got = br.round_select(
        ub, topk_s.to(card), tr_range, tr_start, tts, q_tid, chunk=150, lmax=64
    )
    want = br.round_select(ub_cpu, topk_s, cpu[1], cpu[2], cpu[0], cpu[4], chunk=150, lmax=64)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(ub.cpu(), ub_cpu)
    # A subnormal bound is above the threshold 0: its range is scored.
    picked_tiny = tiny.gather(1, want[0].long())
    assert (want[2].sum(dim=1)[picked_tiny.any(dim=1)] > 0).any()
    acc = torch.from_numpy(gen.choice(np.float32([0.0, 1e-41, 2e-41, 0.75]), size=(33, 4, 64)))
    cand_r = torch.from_numpy(np.stack([gen.permutation(200)[:4] for _ in range(33)]).astype(np.int32))
    ones = torch.ones(200 * 64 + 1)
    s_cpu = torch.full((33, 300), float("-inf"))
    d_cpu = torch.full((33, 300), np.iinfo(np.int32).max, dtype=torch.int32)
    s_gpu, d_gpu = s_cpu.to(card), d_cpu.to(card)
    br.round_merge(acc, cand_r, ones, ones, s_cpu, d_cpu, n_docs=200 * 64)
    br.round_merge(
        acc.to(card), cand_r.to(card), ones.to(card), ones.to(card), s_gpu, d_gpu,
        n_docs=200 * 64,
    )
    assert torch.equal(s_gpu.cpu(), s_cpu) and torch.equal(d_gpu.cpu(), d_cpu)
    assert ((s_cpu > 0) & (s_cpu < 1e-38)).any()


def _boundary_ties(gen, n_q, n_ranges, chunk, card):
    """Bound rows whose equal values straddle the C-th place (C/2 at 9.0,
    then up to 2C at 5.0, the rest lower), and one row (4) with fewer live
    bounds than C, which refills with its lowest -inf ranges."""
    vals = gen.choice(np.float32([0.0, 0.5, 1.25]), size=(n_q, n_ranges))
    n_hi = chunk // 2
    n_tie = min(2 * chunk, n_ranges - n_hi)
    for qi in range(n_q):
        pos = gen.permutation(n_ranges)
        vals[qi, pos[:n_hi]] = 9.0
        vals[qi, pos[n_hi : n_hi + n_tie]] = 5.0
    vals[4] = -np.inf
    vals[4, 3 : 3 + max(1, chunk // 3)] = 5.0
    return torch.from_numpy(vals.astype(np.float32)).to(card)


@pytest.mark.parametrize(
    "n_ranges,max_groups,chunk,k",
    [(37, 11, 1, 5), (37, 11, 37, 5), (1024, 300, 32, 16), (1024, 300, 1024, 1),
     (8192, 900, 128, 16), (16384, 900, 256, 16), (60000, 500, 64, 16),
     (65536, 500, 256, 16), (1000, 300, 1000, 4), (30000, 500, 30000, 4)],
)
def test_round_select_matches_plain(card, gen, n_ranges, max_groups, chunk, k):
    # 60,000 and 65,536 ranges: the row stays in device memory; C = R = 1,000:
    # every range taken, R not a multiple of 32; C = R = 30,000: the keys
    # above the C-th no longer fit shared memory beside the row (scratch).
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    vocab, lmax, n_q = 24, 1024, 33
    tts, tr_range, tr_start, tr_ub = _round_csr(gen, vocab, n_ranges, max_groups, card)
    q_tid = _round_q_tid(gen, n_q, 4, vocab, card)
    ub0 = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax)
    kth = torch.from_numpy(
        gen.choice(np.float32([-np.inf, 0.0, 0.5, 1.25, 3.0, 50.0]), size=n_q)
    ).to(card)
    topk_s = (kth[:, None] + torch.arange(k - 1, -1, -1, device=card)).float().contiguous()
    taken = torch.from_numpy(gen.random((n_q, n_ranges)) < 0.5).to(card)
    taken[2] = True  # a row with nothing left
    rows = (
        ub0,
        torch.where(taken, float("-inf"), ub0).contiguous(),
        _boundary_ties(gen, n_q, n_ranges, chunk, card),
    )
    for ub in rows:
        a, b = ub.clone(), ub.clone()
        before = br.SELECT_LAUNCHES
        got = br.round_select(a, topk_s, tr_range, tr_start, tts, q_tid, chunk=chunk, lmax=lmax)
        torch.cuda.synchronize()
        assert br.SELECT_LAUNCHES == before + 1
        want = br.round_select_plain(
            b, topk_s, tr_range, tr_start, tts, q_tid, chunk=chunk, lmax=lmax
        )
        for g, w, name in zip(got, want, ("cand_r", "start", "length", "flag")):
            assert torch.equal(g, w), name
        assert torch.equal(a, b)  # the rows after masking
        assert bool(got[3]) and got[2].any() and not got[2][0].any()


def test_round_select_refuses_bad_chunk(card, gen):
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    tts, tr_range, tr_start, tr_ub = _round_csr(gen, 24, 37, 11, card)
    q_tid = _round_q_tid(gen, 4, 4, 24, card)
    ub = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=37, lmax=16)
    topk_s = torch.full((4, 3), float("-inf"), device=card)
    for chunk in (0, 38):
        with pytest.raises(ValueError, match="chunk"):
            br.round_select(ub, topk_s, tr_range, tr_start, tts, q_tid, chunk=chunk, lmax=16)
    with pytest.raises(ValueError, match="expected"):
        br.round_select(ub, topk_s.cpu(), tr_range, tr_start, tts, q_tid, chunk=4, lmax=16)


_MERGE_CASES = [
    (3, 32, 300, 8, False), (32, 128, 131072, 16, False), (64, 128, 20000 - 7, 16, False),
    (5, 16, 80, 64, False), (8, 128, 9000, 4096, False), (2, 128, 40000, 16384, False),
    (32, 128, 131072, 1, True), (32, 128, 131072, 16, True), (32, 128, 131072, 32, True),
    (32, 128, 131072, 33, True), (64, 128, 20000 - 7, 32, True), (7, 6, 300, 16, True),
    (8, 128, 9000, 4096, True),
]


@pytest.mark.parametrize(
    "c,rs,n_docs,k,odd",
    _MERGE_CASES,
    ids=[f"{'odd-' if o else ''}{c}-{rs}-{n}-{k}" for c, rs, n, k, o in _MERGE_CASES],
)
def test_round_merge_matches_plain(card, gen, c, rs, n_docs, k, odd):
    # (64, 128): the candidates take two block passes, or two tiles of the
    # key buffer; k = 16,384: the buffer no longer fits shared memory; k <= 32
    # keeps the top-k in registers, k = 33 is the buffer's first.  ``odd``:
    # all-zero, -0, NaN and zero-or-NaN rows beside active ones, negative
    # scores, and live/filter entries that are negative, infinite or NaN, so
    # zero lanes sit next to entries that would make them NaN; (7, 6): a row
    # of 42 lanes, not a multiple of four (no 16-B loads).
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    n_q = 17
    n_ranges = -(-n_docs // rs)
    values = np.float32([1.0, 1.0, 1.0, 0.0, -1.0, np.inf, -np.inf, np.nan])
    if odd:
        live = torch.from_numpy(gen.choice(values, size=n_docs + 1)).to(card)
        filt = torch.from_numpy(gen.choice(values, size=n_docs + 1)).to(card)
    else:
        live = torch.from_numpy((gen.random(n_docs + 1) < 0.8).astype(np.float32)).to(card)
        filt = torch.from_numpy((gen.random(n_docs + 1) < 0.7).astype(np.float32)).to(card)
    got_s = torch.full((n_q, k), float("-inf"), device=card)
    got_d = torch.full((n_q, k), np.iinfo(np.int32).max, dtype=torch.int32, device=card)
    want_s, want_d = got_s.clone(), got_d.clone()
    unseen = [gen.permutation(n_ranges) for _ in range(n_q)]
    for round_no in range(min(3, n_ranges // c)):
        cand_r = torch.from_numpy(
            np.stack([u[round_no * c : (round_no + 1) * c] for u in unseen]).astype(np.int32)
        ).to(card)
        scores = [0.0, -1.5, 0.75, 1.5, 2.25] if odd else [0.0, 0.0, 0.75, 1.5, 2.25]
        acc = gen.choice(np.float32(scores), size=(n_q, c, rs))
        acc[0] = 0.0
        if odd and round_no > 0:
            acc[1] = -0.0
            acc[2] = np.nan
            acc[3] = np.where(gen.random((c, rs)) < 0.5, np.float32(0.0), np.float32(np.nan))
            acc[4, :, : rs // 2] = 0.0
        acc = torch.from_numpy(acc).to(card)
        before = br.MERGE_LAUNCHES
        out = br.round_merge(acc, cand_r, live, filt, got_s, got_d, n_docs=n_docs)
        torch.cuda.synchronize()
        assert br.MERGE_LAUNCHES == before + 1 and out[0].data_ptr() == got_s.data_ptr()
        br.round_merge_plain(acc, cand_r, live, filt, want_s, want_d, n_docs=n_docs)
        assert torch.equal(got_s, want_s) and torch.equal(got_d, want_d), round_no
    assert (got_s > 0).any() and not (got_s[0] > 0).any()  # odd: +inf scores among the hits


@pytest.mark.parametrize("mode", [{}, {"impact_dtype": "bfloat16"}, {"posting_mode": "tf"}])
def test_blockmax_rounds_on_card_equal_cpu(card, gen, mode):
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    n_docs = 40 * 64 - 13
    seg = build_sealed_segment(make_docs(gen, n_docs, vocab=30))
    ri = build_range_index(seg, range_size=64)
    on_card = BlockMaxEngine(seg, ri, chunk=4, device=card, **mode)
    on_cpu = BlockMaxEngine(seg, ri, chunk=4, device="cpu", **mode)
    deleted = gen.random(n_docs) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    queries = [
        Query.from_int_ids(gen.integers(0, 30, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for k, chunk in ((1, None), (10, None), (3000, None), (10, ri.n_ranges)):
        counts = (br.BOUNDS_LAUNCHES, br.SELECT_LAUNCHES, br.MERGE_LAUNCHES)
        got = on_card.search(queries, k, chunk=chunk)
        want = on_cpu.search(queries, k, chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert on_card.last_rounds == on_cpu.last_rounds >= 1
        # One bounds launch a batch, one select a round and the one that
        # ends the loop, one merge a round.
        assert br.BOUNDS_LAUNCHES == counts[0] + 1
        assert br.MERGE_LAUNCHES == counts[2] + on_card.last_rounds
        assert br.SELECT_LAUNCHES - counts[1] in (on_card.last_rounds, on_card.last_rounds + 1)


# ---------------------------------------------------------------------------
# The sharded index's kernels (ops/shard_kernels.py) and the index itself.


@pytest.mark.parametrize(
    "d,q,w,kk",
    [(1, 3, 8, 8), (2, 64, 16, 16), (8, 512, 16, 16), (8, 9, 16, 5), (8, 3, 4096, 1024),
     (3, 2, 7, 21), (8, 3, 4096, 4096), (1, 512, 16, 16), (8, 512, 16, 128)],
)
def test_shard_merge_matches_plain(card, gen, d, q, w, kk):
    # (8, 512, 16, 16): the served size, a block of 128 threads a query;
    # (1, 3, 8, 8) and (1, 512, 16, 16): D = 1, four queries a block of 32
    # threads each; (3, 2, 7, 21) and (8, 512, 16, 128): kk = D * w;
    # (8, 3, 4096, 1024): runs cut to kk, 8,192 keys a query in shared
    # memory; (8, 3, 4096, 4096): 32,768 keys a query, past shared memory
    # (the runs read in device memory).
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    from test_torch_shard_kernels import merge_inputs

    scores, ids, offsets = merge_inputs(gen, d, q, w)
    args = (
        torch.from_numpy(scores).to(card), torch.from_numpy(ids).to(card), [w] * d,
        torch.from_numpy(offsets).to(card), kk,
    )
    before = sk.MERGE_LAUNCHES
    got = sk.shard_merge(*args)
    torch.cuda.synchronize()
    assert sk.MERGE_LAUNCHES == before + 1
    assert torch.equal(got, sk.shard_merge_plain(*args))
    cpu = sk.shard_merge(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize(
    "widths,q,w,kk",
    [((16, 0, 9, 16, 1, 0, 16, 4), 512, 16, 16), ((16, 0, 9, 16, 1, 0, 16, 4), 9, 16, 5),
     ((2, 2), 5, 2, 16), ((0, 0, 0), 4, 4, 4), ((4096, 0, 4096, 4096, 4096, 4096, 4096, 4096, 4096), 2, 4096, 4096)],
)
def test_shard_merge_widths_match_plain(card, gen, widths, q, w, kk):
    # Widths below W and 0, rows that end in pads (kk > the candidates), and
    # 32,768 keys past shared memory beside a width-0 shard; the slots past
    # a width hold garbage the kernel must not read.
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    from test_torch_shard_kernels import merge_inputs

    scores, ids, offsets = merge_inputs(gen, len(widths), q, w)
    for d, wd in enumerate(widths):
        scores[d, :, wd:] = 9.0
        ids[d, :, wd:] = 3
    args = (
        torch.from_numpy(scores).to(card), torch.from_numpy(ids).to(card), list(widths),
        torch.from_numpy(offsets).to(card), kk,
    )
    got = sk.shard_merge(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, sk.shard_merge_plain(*args))


@pytest.mark.parametrize(
    "d,m",
    [(1, 1), (8, 10_001), (3, 262_145), (1, 4_194_305), (8, 262_145), (5, 17)],
)
def test_shard_stats_matches_plain(card, gen, d, m):
    # Odd widths: every row after the first starts unaligned for 16-B loads.
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    doc_fn = torch.from_numpy(gen.integers(0, 256, size=(d, m)).astype(np.uint8)).to(card)
    live = torch.from_numpy((gen.random((d, m)) < 0.9).astype(np.float32)).to(card)
    if d > 1:
        live[d // 2] = 0.0  # an all-dead row
    counts = torch.from_numpy(gen.integers(0, m + 1, size=d)).to(card)
    before = sk.STATS_LAUNCHES
    got = sk.shard_stats(doc_fn, live, counts)
    torch.cuda.synchronize()
    assert sk.STATS_LAUNCHES == before + 1
    slices, shards = sk.STATS_GRID  # a block a slice of a row, a row a shard
    assert shards == d and 1 <= slices <= m
    want = sk.shard_stats_plain(doc_fn, live, counts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if d > 1:
        assert got[0][d // 2].item() == 0.0


def test_shard_stats_on_unaligned_views(card, gen):
    # doc_fn one byte into its storage and doc_live aligned: the two rows
    # never align for vector loads, so every slot goes one at a time.
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    d, m = 3, 5003
    flat = torch.from_numpy(gen.integers(0, 256, size=d * m + 1).astype(np.uint8)).to(card)
    doc_fn = flat[1:].view(d, m)
    live = torch.from_numpy((gen.random((d, m)) < 0.9).astype(np.float32)).to(card)
    counts = torch.tensor([m, m - 1, 3], dtype=torch.int64, device=card)
    got = sk.shard_stats(doc_fn, live, counts)
    want = sk.shard_stats_plain(doc_fn, live, counts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_length_table_uploads_once_a_device(card):
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    first = sk._length_table(card)
    assert first.is_cuda
    assert sk._length_table(torch.device("cuda", torch.cuda.current_device())) is first


_SORT_CASES = [(1, 2, 1, None, False), (3, 1024, 700, None, False),
               (2, 1 << 15, 20_000, None, False), (8, 1 << 13, 4000, None, False)]
_SORT_CASES += [
    (d, p, fill, kind, shuffled)
    for d, p, fill, kind in [
        (3, 1 << 13, 6000, "grouped"), (2, 1 << 14, 12_000, "one_key"),
        (3, 1 << 12, 3000, "k3_only"), (2, 1 << 12, 3000, "single_bin"),
        (2, 1 << 20, 900_000, "grouped"),
    ]
    for shuffled in (False, True)
]


@pytest.mark.parametrize(
    "d,p,fill,kind,shuffled",
    _SORT_CASES,
    ids=[
        f"{d}-{p}-{fill}" if kind is None else f"{kind}{'-shuffled' if sh else ''}-{d}-{p}-{fill}"
        for d, p, fill, kind, sh in _SORT_CASES
    ],
)
def test_posting_sort_matches_plain(card, gen, d, p, fill, kind, shuffled):
    # kind None: sort_columns' shuffled rows, or all -1 (every digit one bin:
    # no pass).  Else layout_columns' rows staged as the device build stages
    # them (the doc passes skipped) or, shuffled, with every pass run.
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    from test_torch_shard_kernels import census_of, layout_columns, sort_columns

    if kind is not None:
        cols = layout_columns(gen, d, p, fill, kind, shuffled)
    elif fill < 17:  # too few postings for the forced keys: random columns
        cols = [np.full((d, p), -1, dtype=np.int32) for _ in range(6)]
    else:
        cols = sort_columns(gen, d, p, fill)
    plan = sk.sort_passes(census_of(cols))
    dev = [torch.from_numpy(c).to(card) for c in cols]
    ptrs = [c.data_ptr() for c in dev]
    want = sk.posting_sort_plain(dev)
    before = sk.SORT_LAUNCHES
    got = sk.posting_sort(dev)
    torch.cuda.synchronize()
    assert sk.SORT_LAUNCHES == before + 1 and sk.SORT_PASSES == len(plan)
    assert [c.data_ptr() for c in got] == ptrs  # in place, odd pass counts included
    if kind is not None:
        assert any(w == 4 for w, _ in plan) == shuffled
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shard_kernels_reject_bad_inputs(card):
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    cols = [torch.zeros((2, 48), dtype=torch.int32, device=card) for _ in range(6)]
    with pytest.raises(ValueError):
        sk.posting_sort(cols)  # not a power of two
    s = torch.zeros((2, 3, 4), device=card)
    off = torch.zeros(2, dtype=torch.int64, device=card)
    with pytest.raises(ValueError):  # mixed devices
        sk.shard_merge(s, torch.zeros((2, 3, 4), dtype=torch.int32), [4, 4], off, 4)
    many = sk.MAX_MERGE_SHARDS + 1
    with pytest.raises(ValueError):  # more shards than the launch's run table
        sk.shard_merge(
            torch.zeros((many, 1, 1), device=card),
            torch.zeros((many, 1, 1), dtype=torch.int32, device=card),
            [1] * many, torch.zeros(many, dtype=torch.int64, device=card), 1,
        )


@pytest.mark.parametrize(
    "engine,opts",
    [
        ("stream", {}),
        ("stream", {"strategy": "maxscore"}),
        ("exact", {}),
        ("hybrid", {}),
        ("hybrid", {"memory_mode": "compact"}),
        ("blockmax", {}),
        ("blockmax", {"posting_mode": "tf"}),
    ],
)
def test_sharded_index_on_card_equals_cpu(card, gen, engine, opts):
    from vectorchord_bm25_tpu_torch import Document, Query as PQuery, ShardedIndex
    from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk

    docs = [Document(keys=d.keys, values=d.values) for d in make_docs(gen, 3000, vocab=60)]
    build = {k: v for k, v in opts.items() if k != "memory_mode"}
    on_card = ShardedIndex.build(docs, 8, device=card, engine=engine, **build)
    on_cpu = ShardedIndex.build(docs, 8, device="cpu", engine=engine, device_build=False, **build)
    if "memory_mode" in opts:
        on_card, on_cpu = (
            ShardedIndex([v.segment for v in ix.views], ix.options, device=dev,
                         engine=engine, memory_mode=opts["memory_mode"])
            for ix, dev in ((on_card, card), (on_cpu, "cpu"))
        )
    for ix in (on_card, on_cpu):
        ix.set_deleted(np.arange(3000) % 17 == 0)
        ix.insert(docs[5], 99_999)
    queries = [
        PQuery.from_int_ids(gen.integers(0, 60, size=int(n)).tolist())
        for n in gen.integers(1, 6, size=40)
    ]
    for k in (10, 700):
        before = sk.MERGE_LAUNCHES
        got = on_card.search(queries, k)
        want = on_cpu.search(queries, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if not opts.get("strategy"):
            assert sk.MERGE_LAUNCHES > before
    assert on_card.global_stats_step() == on_cpu.global_stats_step()
    assert on_card.memory_report() == on_cpu.memory_report()
