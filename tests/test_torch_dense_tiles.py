"""The doc-tile walk S1 and E1 share (``ops/dense_tiles.py``, the statement
of ``csrc/dense_tiles.cuh``), on the CPU.

- The layout checks (``stream_spans_in_layout``, ``dense_rows_in_layout``)
  equal an entry-by-entry numpy statement of the rule on random lists.
- Every planner that feeds S1 or E1 hands the kernels lists on the layout:
  the stream engine's dense dispatches (repeated terms, empty and absent
  queries, bucket rows and pad windows, several dispatches), the sharded
  per-shard lists, the growing segment, the exact planner unfiltered and
  filtered, and the hybrid engine's exact group.  So the kernels' parallel
  walk, not their one-thread path, serves every planned call.
- The block's window selection (``taken_windows``) over the tiles of
  ``tile_split`` visits every live lane exactly once, for tiles that do and
  do not divide the row; a tile-by-tile emulation of the walk (taken
  windows only, one ordinal at a time) equals the plain versions bit for
  bit, the bucket rows, the pad column and the stride padding included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import (  # noqa: E402
    Bm25Index,
    Document,
    ExactEngine,
    HybridEngine,
    IndexOptions,
    Query,
    SessionConfig,
    ShardedIndex,
    StreamEngine,
    build_sealed_segment,
    random_seed,
)
from vectorchord_bm25_tpu_torch.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import dense_tiles, exact_kernel, stream_kernel  # noqa: E402
from vectorchord_bm25_tpu_torch.ops.dense_tiles import PAD  # noqa: E402
from vectorchord_bm25_tpu_torch.parallel import shard  # noqa: E402
from vectorchord_bm25_tpu_torch.search import exact as port_exact  # noqa: E402
from vectorchord_bm25_tpu_torch.search import stream as port_stream  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


torch.set_num_threads(2)


def make_docs(rng, n_docs, vocab, max_len=30):
    return [
        Document.from_int_ids(rng.integers(0, vocab, size=int(rng.integers(1, max_len))).tolist())
        for _ in range(n_docs)
    ]


def make_queries(rng, n, vocab):
    """Random queries of 1-6 terms, then a repeated term, an absent one and
    an empty query."""
    qs = [
        Query.from_int_ids(rng.integers(0, vocab, size=int(t)).tolist())
        for t in rng.integers(1, 7, size=n)
    ]
    return qs + [
        Query.from_int_ids([3, 3, 5]),
        Query.from_int_ids([10**6]),
        Query(keys=np.zeros(0, dtype="S16")),
    ]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0xD1)
    docs = make_docs(rng, 1500, 60)
    return docs, build_sealed_segment(docs), make_queries(rng, 40, 60)


def record(monkeypatch, module, name):
    """Keep the arguments of every call of ``module.name``."""
    real = getattr(module, name)
    calls = []

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, rec)
    return calls


# --- the layout rule, entry by entry ---------------------------------------


def list_ok_numpy(keys, firsts, bads):
    """L1 and L2 on one list: real entries (key != PAD) first in
    non-decreasing key order, strictly rising first docs inside one key,
    pads after them; no real entry bad."""
    prev_key, prev_first = -1, 0
    for key, first, bad in zip(keys, firsts, bads):
        if key != PAD:
            if bad or prev_key == PAD or prev_key > key:
                return False
            if prev_key == key and prev_first >= first:
                return False
        prev_key, prev_first = key, first
    return True


def planned_list(rng, n_runs, w_len):
    """(ordinals, first docs) of one planned list: runs of rising first
    docs, non-decreasing ordinals."""
    ords, firsts = [], []
    for o in range(n_runs):
        n = int(rng.integers(1, 6))
        ords += [o] * n
        firsts += list(np.sort(rng.choice(w_len, n, replace=False)))
    return np.array(ords, dtype=np.int64), np.array(firsts, dtype=np.int64)


def perturb(rng, ords, firsts):
    """One random break (or none) of a planned list."""
    ords, firsts = ords.copy(), firsts.copy()
    kind = int(rng.integers(0, 6))
    n = ords.size
    if n >= 2 and kind == 0:  # two entries swapped
        i, j = rng.choice(n, 2, replace=False)
        ords[[i, j]], firsts[[i, j]] = ords[[j, i]], firsts[[j, i]]
    elif n >= 2 and kind == 1:  # a first doc repeated
        i = int(rng.integers(1, n))
        firsts[i] = firsts[i - 1]
    elif n and kind == 2:  # a pad in the middle, or trailing pads
        ords[int(rng.integers(0, n)) :] = -1
        if rng.random() < 0.5:
            ords[-1] = 0
    elif n and kind == 3:  # an ordinal lowered
        ords[int(rng.integers(0, n))] -= 1
    return ords, firsts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stream_layout_check_matches_numpy(seed):
    # stream_spans_in_layout on spans of a window list (clamped, empty and
    # reversed spans included) against the entry-by-entry rule.
    rng = np.random.default_rng(seed)
    w_len = 400
    w_base = torch.from_numpy((np.arange(w_len) * 7).astype(np.int32))
    wsrc, w_ord, q_start = [], [], [0]
    for _ in range(30):
        ords, firsts = perturb(rng, *planned_list(rng, int(rng.integers(0, 5)), w_len))
        wsrc.append(firsts)
        w_ord.append(ords)
        q_start.append(q_start[-1] + ords.size)
    wsrc, w_ord = np.concatenate(wsrc), np.concatenate(w_ord)
    wsrc = np.append(wsrc, [w_len - 1] * 5).astype(np.int32)  # trailing pads
    w_ord = np.append(w_ord, [-1] * 5).astype(np.int32)
    q_start = np.array(q_start, dtype=np.int32)
    q_start[5] = q_start[4] - 1  # a span whose end lies before its start
    q_start[-1] += 40  # past the list: clamped
    got = stream_kernel.stream_spans_in_layout(
        torch.from_numpy(wsrc), torch.from_numpy(q_start), torch.from_numpy(w_ord), w_base
    ).numpy()
    want = []
    base = w_base.numpy()
    for q in range(q_start.size - 1):
        lo = min(max(q_start[q], 0), wsrc.size)
        hi = min(max(q_start[q + 1], lo), wsrc.size)
        keys = np.where(w_ord[lo:hi] >= 0, w_ord[lo:hi], PAD)
        want.append(list_ok_numpy(keys, base[wsrc[lo:hi]], np.zeros(hi - lo, bool)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_layout_check_matches_numpy(seed):
    # dense_rows_in_layout on [q, P] window matrices: planned rows with
    # breaks, empty lanes, rows out of range and ordinals past n_ord.
    rng = np.random.default_rng(seed)
    n_rows, p = 50, 16
    post_docid = np.sort(rng.integers(0, 10**6, size=(n_rows + 1) * 128)).reshape(-1, 128)
    post_docid = torch.from_numpy(post_docid.astype(np.int32))
    q = 40
    win_row = np.full((q, p), n_rows, dtype=np.int32)
    win_lo = np.zeros((q, p), dtype=np.int32)
    win_hi = np.zeros((q, p), dtype=np.int32)
    win_ord = np.full((q, p), -1, dtype=np.int32)
    for r in range(q):
        ords, firsts = perturb(rng, *planned_list(rng, int(rng.integers(0, 4)), n_rows))
        ords, firsts = ords[:p], firsts[:p]
        n = ords.size
        win_ord[r, :n] = ords
        win_row[r, :n] = firsts
        win_lo[r, :n] = rng.integers(0, 64, size=n)
        win_hi[r, :n] = win_lo[r, :n] + rng.integers(1, 65, size=n)
        kind = int(rng.integers(0, 5))
        if n and kind == 0:
            win_hi[r, int(rng.integers(0, n))] = win_lo[r, 0]  # no lanes
        elif n and kind == 1:
            win_row[r, int(rng.integers(0, n))] = n_rows + 1  # a row out of range
        elif n and kind == 2:
            win_ord[r, n - 1] = 7  # past n_ord: a pad
    n_ord = 5
    args = [torch.from_numpy(x) for x in (win_row, win_lo, win_hi, win_ord)]
    got = exact_kernel.dense_rows_in_layout(post_docid, *args, n_ord).numpy()
    want = []
    pd = post_docid.numpy()
    for r in range(q):
        keys, firsts, bads = [], [], []
        for j in range(p):
            o, row, lo, hi = win_ord[r, j], win_row[r, j], win_lo[r, j], win_hi[r, j]
            keys.append(o if 0 <= o < n_ord else PAD)
            bad = not (0 <= row < n_rows + 1 and 0 <= lo < hi <= 128)
            bads.append(bad)
            firsts.append(0 if bad else pd[row, lo])
        want.append(list_ok_numpy(keys, firsts, bads))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


# --- the planners' lists keep the layout -----------------------------------


def assert_stream_calls_in_layout(calls):
    assert calls
    for args, _ in calls:
        words, s1, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord, n_q, n_docs = args
        assert stream_kernel.stream_spans_in_layout(wsrc, q_start, w_ord, w_base).all()
        # The windows outside every span are the bucket's pads: ordinal -1,
        # the zero-length pad window.
        t = int(q_start[-1])
        assert (w_ord[t:] == -1).all() and (w_meta[wsrc[t:].long()] == 0).all()


def assert_exact_calls_in_layout(calls, filtered):
    assert calls
    for args, kw in calls:
        post_docid, _, _, win_row, win_lo, win_hi, win_ord, n_ord, _ = args
        assert exact_kernel.dense_rows_in_layout(
            post_docid, win_row, win_lo, win_hi, win_ord, n_ord
        ).all()
        assert (kw.get("filter_mask") is not None) == filtered


@pytest.mark.parametrize("budget", [1 << 30, 4 * 1501 * 5])
def test_stream_dispatches_in_layout(corpus, monkeypatch, budget):
    # One dispatch, and (budget) a dispatch every 5 queries, rows bucketed.
    _, seg, queries = corpus
    engine = StreamEngine(seg, device="cpu", strategy="dense", accumulator_budget=budget)
    calls = record(monkeypatch, port_stream, "stream_dense_accumulate")
    engine.search(queries, 10)
    assert_stream_calls_in_layout(calls)
    assert len(calls) == (1 if budget == 1 << 30 else -(-len(queries) // 5))
    # Bucket rows (5 queries in 8 rows) own empty spans.
    assert all((np.diff(a[7].numpy()) == 0).any() for a, _ in calls[1:])


def test_growing_segment_in_layout(corpus, monkeypatch):
    docs, seg, queries = corpus
    index = Bm25Index(seg, random_seed(), IndexOptions(), device="cpu")
    rng = np.random.default_rng(5)
    for j, doc in enumerate(make_docs(rng, 600, 60)):
        index.insert(doc, 10**6 + j)
    calls = record(monkeypatch, port_stream, "stream_dense_accumulate")
    ids, qidx = batch_lookup(index.sealed.lookup_tokens, queries)
    index.growing.topk_batch_async(ids, qidx, len(queries), 10, None)()
    assert_stream_calls_in_layout(calls)


@pytest.mark.parametrize("filtered", [False, True])
def test_exact_planner_in_layout(corpus, monkeypatch, filtered):
    _, seg, queries = corpus
    engine = ExactEngine(seg, device="cpu", strategy="dense")
    calls = record(monkeypatch, port_exact, "exact_dense_accumulate")
    fm = np.random.default_rng(2).random(seg.n_docs) < 0.6 if filtered else None
    engine.search(queries, 10, filter_mask=fm)
    assert_exact_calls_in_layout(calls, filtered)


def test_hybrid_exact_group_in_layout(corpus, monkeypatch):
    _, seg, queries = corpus
    engine = HybridEngine(seg, build_range_index(seg), device="cpu")
    calls = record(monkeypatch, port_exact, "exact_dense_accumulate")
    engine.search(queries, 10)
    assert_exact_calls_in_layout(calls, False)


@pytest.mark.parametrize("engine,filtered", [("stream", False), ("exact", False), ("exact", True), ("hybrid", False)])
def test_sharded_lists_in_layout(corpus, monkeypatch, engine, filtered):
    docs, _, queries = corpus
    index = ShardedIndex.build(docs, 8, device="cpu", engine=engine)
    name = "stream_dense_accumulate" if engine == "stream" else "exact_dense_accumulate"
    calls = record(monkeypatch, shard, name)
    keep = (lambda p: p % 3 != 0) if filtered else None
    index.search(queries, 10, filter_fn=keep, session=SessionConfig(prefilter=True))
    if engine == "stream":
        assert_stream_calls_in_layout(calls)
    else:
        assert_exact_calls_in_layout(calls, filtered)


# --- the tiles and the windows a block takes -------------------------------


@pytest.mark.parametrize("stride,tile", [(4, 4), (3072, 1024), (3072, 1000), (3004, 256), (3004, 8192), (131076, 8192)])
def test_tile_split(stride, tile):
    width, n_tiles = dense_tiles.tile_split(stride, tile)
    assert width % 4 == 0 and 4 <= width <= tile
    assert (n_tiles - 1) * width < stride <= n_tiles * width


def stream_case(seg, queries, budget=1 << 30):
    """The stream engine's dispatches' arguments on the CPU."""
    engine = StreamEngine(seg, device="cpu", strategy="dense", accumulator_budget=budget)
    out = []
    for _, wsrc, q_start, w_ord, n_qb in engine._dispatches(engine._layout(*looked_up(engine, queries))[0]):
        out.append((
            engine.dev_words, engine.dev_s1bd, *engine._window_tables(),
            *(torch.from_numpy(x) for x in (wsrc, q_start, w_ord)), n_qb, engine.n_docs,
        ))
    return out


def emulate_stream_tiles(args, tile):
    """The kernel's walk, tile by tile: zero the tile, add the taken
    windows' lanes inside it one ordinal at a time, write it.  Also
    returns how often each (window entry, lane) was added."""
    words, s1, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord, n_q, n_docs = args
    stride = (n_docs + 1 + 3) & ~3
    width, n_tiles = dense_tiles.tile_split(stride, tile)
    out = torch.full((n_q, stride), float("nan"))
    visits = torch.zeros((wsrc.numel(), 128), dtype=torch.int64)
    qs = q_start.tolist()
    for q in range(n_q):
        ent = torch.arange(qs[q], qs[q + 1])
        ws = wsrc[ent].long()
        key = torch.where(w_ord[ent] >= 0, w_ord[ent], PAD)
        first = w_base[ws]
        doc, sc = stream_kernel.unpack_and_score_plain(
            words, s1, w_off[ws], w_base[ws], w_meta[ws], w_s0[ws], n_docs
        )
        live = torch.arange(128) < (w_meta[ws].int() & 0xFF)[:, None]
        for j in range(n_tiles):
            tlo, thi = j * width, min((j + 1) * width, stride)
            cells = torch.zeros(thi - tlo)
            take = dense_tiles.taken_windows(key, first, tlo, thi)
            inside = take[:, None] & live & (doc >= tlo) & (doc < thi) & (doc <= n_docs)
            visits[ent] += inside.long()
            for o in torch.unique(key[take]).tolist():
                m = inside & (key == o)[:, None]
                cells.index_add_(0, doc[m].long() - tlo, sc[m])
            out[q, tlo:thi] = cells
    return out, visits


@pytest.mark.parametrize("n_docs,tile", [(3071, 1024), (3071, 1000), (3071, 8192), (2999, 256), (2999, 12)])
def test_taken_windows_visit_every_lane_once(n_docs, tile):
    # Tiles that divide N+1 (3072 / 1024), that do not, wider than the row,
    # and narrower than a window's span; the walk equals the plain version.
    rng = np.random.default_rng(n_docs + tile)
    docs = make_docs(rng, n_docs, 30, max_len=20)
    seg = build_sealed_segment(docs)
    queries = make_queries(rng, 9, 30)
    (args,) = stream_case(seg, queries)
    got, visits = emulate_stream_tiles(args, tile)
    words, s1, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord, n_q, _ = args
    t = int(q_start[-1])
    live = (torch.arange(128) < (w_meta[wsrc[:t].long()].int() & 0xFF)[:, None])
    assert torch.equal(visits[:t], live.long())  # every live lane once
    assert not visits[t:].any()  # pad windows: nothing
    want = stream_kernel.stream_dense_accumulate_plain(*args)
    full = want.as_strided((n_q, got.shape[1]), (want.stride(0), 1))
    assert torch.equal(got, full)  # zeros, pad column and padding included
    assert (got[len(queries) :] == 0).all() and n_q > len(queries)  # bucket rows


def emulate_exact_tiles(args, filter_mask, tile):
    """E1's walk, tile by tile, as ``emulate_stream_tiles``."""
    post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord, n_ord, n_docs = args
    stride = (n_docs + 1 + 3) & ~3
    width, n_tiles = dense_tiles.tile_split(stride, tile)
    q, p = win_row.shape
    out = torch.full((q, stride), float("nan"))
    lane = torch.arange(128)
    for r in range(q):
        key = torch.where((win_ord[r] >= 0) & (win_ord[r] < n_ord), win_ord[r], PAD)
        rows = win_row[r].long()
        first = post_docid[rows, win_lo[r].long().clamp(0, 127)]
        d = post_docid[rows]
        valid = (lane >= win_lo[r][:, None]) & (lane < win_hi[r][:, None])
        sc = post_impact[rows].float() * doc_live[d.long()]
        for j in range(n_tiles):
            tlo, thi = j * width, min((j + 1) * width, stride)
            cells = torch.zeros(thi - tlo)
            take = dense_tiles.taken_windows(key, first, tlo, thi)
            inside = take[:, None] & valid & (d >= tlo) & (d < thi) & (d <= n_docs)
            for o in torch.unique(key[take]).tolist():
                m = inside & (key == o)[:, None]
                cells.index_add_(0, d[m].long() - tlo, sc[m])
            if filter_mask is not None:
                n = min(thi, n_docs + 1) - tlo
                cells[:n] *= filter_mask[tlo : tlo + n]
            out[r, tlo:thi] = cells
    return out


@pytest.mark.parametrize("impact_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("tile", [256, 1000])
def test_exact_tile_walk_equals_plain(corpus, impact_dtype, filtered, tile):
    _, seg, queries = corpus
    engine = ExactEngine(seg, device="cpu", strategy="dense", impact_dtype=impact_dtype)
    engine.set_deleted(np.random.default_rng(3).random(seg.n_docs) < 0.1)
    wr, wl, wh, wo = engine._prepare(*looked_up(engine, queries))
    dev = engine.dev
    args = (
        dev.post_docid, dev.post_impact, dev.doc_live,
        *(torch.from_numpy(x) for x in (wr, wl, wh, wo)), int(wo.max()) + 1, seg.n_docs,
    )
    fm = None
    if filtered:
        fm = torch.ones(seg.n_docs + 1)
        fm[: seg.n_docs] = torch.from_numpy((np.random.default_rng(4).random(seg.n_docs) < 0.6).astype(np.float32))
    got = emulate_exact_tiles(args, fm, tile)
    want = exact_kernel.exact_dense_accumulate_plain(*args, filter_mask=fm)
    assert torch.equal(got, want.as_strided(got.shape, (want.stride(0), 1)))
    assert (got > 0).sum() > 1000
