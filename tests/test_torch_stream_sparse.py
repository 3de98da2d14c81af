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
    _, seg_off, _ = segmented_matrix(si, terms)
    s, i = stream_sparse.stream_sparse_topk(
        *port_tensors(si, s1_eff), torch.from_numpy(mat), k, si.n_docs, seg_steps,
        torch.from_numpy(seg_off),
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


# --- SP-stream (csrc/sparse_merge.cu) and its decomposition, on the CPU

K_LANES = 2048  # csrc/sparse_merge.cuh kLanes
INF_BITS = 0x7F800000


def _pack_key(score, doc):
    """ops/topk.py's packed key of a candidate, as a Python int."""
    bits = int(np.float32(score).view(np.uint32))
    return ((INF_BITS - bits) << 32) | int(doc)


def _tree_sum(xs):
    """The reference scan's value at a run's last lane: S4's binary-counter
    stack over the run's postings, its last segment's first."""
    val, lev = [], []
    for x in xs:
        v, lv = np.float32(x), 0
        while lev and lev[-1] == lv:
            v = np.float32(val.pop() + v)
            lev.pop()
            lv += 1
        val.append(v)
        lev.append(lv)
    s = val.pop()
    while val:
        s = np.float32(val.pop() + s)
    return s


def sparse_merge_model(doc, sc, base, seg_off, k, n_docs, seg_steps,
                       lanes=K_LANES, least=8192, n_sm=132):
    """The sparse kernels' decomposition in numpy (csrc/sparse_merge.cuh):
    the block plan, each part's lane-balanced doc range, the tiles sized
    from the window bases (cut again where they overflow ``lanes``), each
    doc's run summed in segment order with the scan's tree, a part's kk best
    keys and its capped pad docs, and the row's merge; a one-doc tile past
    ``lanes`` (more segments than lanes hold the doc) sums its run in chunks
    of ``lanes`` segments, the last first.  doc, sc [Q, P, 128]
    a window's lanes (dead lanes doc n_docs), base [Q, P] a window's first
    doc, seg_off [Q, S+1].  Returns (scores, ids, stats)."""
    q_n, p, _ = doc.shape
    kk = min(k, p * 128)
    target = lanes * 3 // 4
    out_s = np.full((q_n, k), -np.inf, np.float32)
    out_i = np.zeros((q_n, k), np.int32)
    n_win = np.clip(seg_off[:, -1], 0, p)
    plan = stream_sparse.merge_plan(n_win, kk, n_sm, least)
    parts_of = np.bincount(plan >> 12, minlength=q_n)
    stats = {"blocks": int(plan.size), "tiles": 0, "overflows": 0, "one_doc": 0, "pad_rows": 0}
    reach = 1 << seg_steps
    for q in range(q_n):
        bq = base[q]
        segs = [
            (min(max(int(seg_off[q, j]), 0), n_win[q]), 0) for j in range(seg_off.shape[1] - 1)
        ]
        segs = [
            (w0, min(max(int(seg_off[q, j + 1]), w0), n_win[q])) for j, (w0, _) in enumerate(segs)
        ]
        n_all = sum(w1 - w0 for w0, w1 in segs)
        parts = int(parts_of[q])

        def count(d):
            return sum(int(np.searchsorted(bq[w0:w1], d, "left")) for w0, w1 in segs)

        def split(i):
            if i == 0:
                return 0
            if i == parts:
                return n_docs
            lo, hi = 0, n_docs
            while lo < hi:
                m = (lo + hi) // 2
                if count(m) * parts >= i * n_all:
                    hi = m
                else:
                    lo = m + 1
            return lo

        def in_range(w, a, b, w_end):
            lo = int(bq[w])
            if w + 1 < w_end:
                hi = int(bq[w + 1])
            else:
                hi = lo + max(1, lo - int(bq[w - 1])) if w > 0 else lo + 1
            hi = max(hi, lo + 1)
            inside = min(hi, b) - max(lo, a)
            return 0 if inside <= 0 else (128 * inside + (hi - lo) - 1) // (hi - lo)

        blocks = []
        for part in range(parts):
            lo_b = split(part)
            hi_b = max(lo_b, split(part + 1))
            cur, end = [], []
            for w0, w1 in segs:
                e = w0 + int(np.searchsorted(bq[w0:w1], hi_b, "left"))
                c = w0 + int(np.searchsorted(bq[w0:e], lo_b, "right")) - 1
                cur.append(max(c, w0))
                end.append(e)
            total = sum(e - c for c, e in zip(cur, end))
            width = hi_b - lo_b
            D = width if total * 128 <= lanes else max(1, width * target // (total * 128))
            c_b = nc_b = 0
            keys, pads = [], []
            a = lo_b
            while a < hi_b:
                b = min(hi_b, a + D)
                while True:
                    tot = est = 0
                    cnt = []
                    for j, (w0, w1) in enumerate(segs):
                        c0, e = cur[j], end[j]
                        c = max(c0, c0 + int(np.searchsorted(bq[c0:e], a, "right")) - 1)
                        n = int(np.searchsorted(bq[c:e], b, "left"))
                        cur[j] = c
                        cnt.append(n)
                        if n:
                            tot += n
                            est += 128 * (n - 2) + in_range(c, a, b, w1) + (
                                in_range(c + n - 1, a, b, w1) if n > 1 else 128
                            )
                    if est <= lanes - lanes // 8 or b - a <= 1 or tot == 0:
                        break
                    b = a + max(1, (b - a) * target // est)
                if tot == 0:
                    nxt = [int(bq[cur[j]]) for j in range(len(segs)) if cur[j] < end[j]]
                    a = max(b, min(nxt, default=hi_b))
                    continue
                nxt = [hi_b]
                run = {}
                for j in range(len(segs)):
                    if cur[j] + cnt[j] < end[j]:
                        nxt.append(int(bq[cur[j] + cnt[j]]))
                    for w in range(cur[j], cur[j] + cnt[j]):
                        d, v = doc[q, w], sc[q, w]
                        live = d < n_docs
                        nxt.extend(int(x) for x in d[live & (d >= b)])
                        for x, y in zip(d[live & (d >= a) & (d < b)], v[live & (d >= a) & (d < b)]):
                            run.setdefault(int(x), []).append((j, y))
                n_lanes = sum(len(r) for r in run.values())
                if n_lanes > lanes and b - a > 1:
                    stats["overflows"] += 1
                    D = max(1, (b - a) // 2)
                    continue
                stats["tiles"] += 1
                non = []
                for d, r in run.items():
                    if n_lanes > lanes:  # one doc: its lanes by chunk of segments
                        stats["one_doc"] += 1
                        by_seg, xs = dict(r), []
                        for j1 in range(len(segs), 0, -lanes):
                            xs += [by_seg[j] for j in range(j1 - 1, max(0, j1 - lanes) - 1, -1)
                                   if j in by_seg]
                            if len(xs) >= reach:
                                break
                        xs = xs[:reach]
                    else:
                        xs = [y for _, y in sorted(r, key=lambda e: -e[0])][:reach]
                    s = _tree_sum(xs)
                    cand = s > 0
                    if cand:
                        keys.append(_pack_key(s, d))
                    non.extend([d] * (len(r) - int(cand)))
                c_b += n_lanes - len(non)
                nc_b += len(non)
                cap = kk - c_b - len(pads)
                if cap > 0 and non:
                    pads.extend(sorted(non)[:cap])
                D = max(1, (b - a) * target // max(est, target // 8))
                a = max(b, min(nxt))
            blocks.append((c_b, nc_b, sorted(keys)[:kk], pads))
        c = sum(x[0] for x in blocks)
        row = sorted(key for x in blocks for key in x[2])[:kk]
        if c < kk:
            stats["pad_rows"] += 1
            left, got = kk - c, []
            for c_x, nc_x, _, pads in blocks:
                if left <= 0:
                    break
                got.extend(pads)
                left -= min(nc_x, left)
            got = sorted(got)[: kk - c - left]
            row += [(INF_BITS << 32) | d for d in got] + [(INF_BITS << 32) | n_docs] * left
        for i, key in enumerate(row):
            hi = key >> 32
            out_s[q, i] = -np.inf if hi == INF_BITS else np.uint32(INF_BITS - hi).view(np.float32)
            out_i[q, i] = key & 0xFFFFFFFF
    return out_s, out_i, stats


def stream_model(si, s1_eff, mat, seg_off, k, seg_steps, **kw):
    """``sparse_merge_model`` on a stream window matrix (the plain decode's
    lanes, the windows' w_base)."""
    q, p = mat.shape
    doc, sc = stream_sparse.stream_sparse_decode_plain(
        *port_tensors(si, s1_eff), torch.from_numpy(mat), si.n_docs
    )
    base = tables(si)[1][mat]
    return sparse_merge_model(
        doc.numpy().reshape(q, p, 128), sc.numpy().reshape(q, p, 128), base,
        np.asarray(seg_off), k, si.n_docs, seg_steps, **kw,
    )


def segmented_matrix(si, query_terms, prefix=None, rng=None):
    """The sparse path's [Q, P] matrix with its segments: each query's term
    spans in term order (``prefix(t)``: a term's windows as MaxScore's
    phase 1 lists them, else all, in id order), padded with W to at least 8
    columns.  Returns (matrix, seg_off [Q, S+1] int32, most terms)."""
    tws = si.token_w_start
    rows, cnts = [], []
    for terms in query_terms:
        spans = [prefix(t) if prefix else np.arange(tws[t], tws[t + 1]) for t in terms]
        rows.append(np.concatenate(spans) if spans else np.zeros(0, np.int64))
        cnts.append([s.size for s in spans])
    mat = np.full((len(rows), max(8, max(r.size for r in rows))), si.n_windows, np.int32)
    for i, r in enumerate(rows):
        mat[i, : r.size] = r
    n_s = max(1, max(len(c) for c in cnts))
    seg_off = np.zeros((len(rows), n_s + 1), np.int32)
    for i, c in enumerate(cnts):
        off = np.cumsum([0] + c)
        seg_off[i, : off.size] = off
        seg_off[i, off.size:] = off[-1]
    return mat, seg_off, max(1, max(len(t) for t in query_terms))


SEG_CASES = ["repeated_terms", "permuted_windows", "maxscore_prefix", "all_deleted",
             "deepest_scan", "k_above_lanes"]


@pytest.mark.parametrize("case", SEG_CASES)
@pytest.mark.parametrize("k", [10, 512, 2048])
def test_sparse_topk_segments_equal_reference(rng, case, k):
    # The wrapper's CPU path given each row's segments, and the numpy model
    # of SP-stream's decomposition, against _stream_sparse: scores bit-equal
    # and ids equal, the -inf pads' too.
    si = build_stream_index(width_segment(rng, 15, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng, 1.0 if case == "all_deleted" else 0.1)
    terms = [[1, 1, 2], [0, 3, 3, 3, 5], [7], []] + [
        rng.integers(0, si.n_tokens, size=int(rng.integers(1, 5))).tolist() for _ in range(4)
    ]
    prefix = None
    if case == "deepest_scan":
        terms = [[4] * 33, [5, 6] * 20]  # runs of 33 and 20 lanes
    elif case == "maxscore_prefix":
        tws = si.token_w_start
        imp = np.lexsort((-si.w_maximp, si.w_token))

        def prefix(t):  # a term's highest-impact windows, impact order
            span = imp[tws[t]:tws[t + 1]]
            return span[: max(1, (span.size + 1) // 2)]

    mat, seg_off, mt = segmented_matrix(si, terms, prefix)
    seg_steps = int(mt - 1).bit_length()
    if case == "deepest_scan":
        seg_steps = int(mat.shape[1] * 128 - 1).bit_length()  # the widest scan the row takes
    if case == "k_above_lanes":
        k = mat.shape[1] * 128 + k
    ordered = mat.copy()
    for i in range(mat.shape[0]):  # each segment's windows in doc order
        for j in range(seg_off.shape[1] - 1):
            a, b = seg_off[i, j], seg_off[i, j + 1]
            ordered[i, a:b] = np.sort(mat[i, a:b])
    shown = mat
    if case == "permuted_windows":
        shown = ordered.copy()
        for i in range(mat.shape[0]):
            for j in range(seg_off.shape[1] - 1):
                a, b = seg_off[i, j], seg_off[i, j + 1]
                shown[i, a:b] = rng.permutation(shown[i, a:b])
    dw, tw = _active_widths(si.w_meta[mat[mat < si.n_windows]])
    ref = lambda m: _stream_sparse(  # noqa: E731
        *ref_tables(si, s1_eff), jnp.asarray(m), k=k, n_docs=si.n_docs,
        seg_steps=seg_steps, dwidths=dw, twidths=tw,
    )
    r_s, r_i = (np.asarray(x) for x in ref(shown))
    if case in ("permuted_windows", "maxscore_prefix"):
        # Where a window sits inside its segment changes nothing.
        o_s, o_i = (np.asarray(x) for x in ref(ordered))
        assert np.array_equal(o_s, r_s) and np.array_equal(o_i, r_i)
    s, i = stream_sparse.stream_sparse_topk(
        *port_tensors(si, s1_eff), torch.from_numpy(shown), k, si.n_docs, seg_steps,
        torch.from_numpy(seg_off),
    )
    assert np.array_equal(s.numpy(), r_s)
    np.testing.assert_array_equal(i.numpy(), r_i)
    m_s, m_i, st = stream_model(si, s1_eff, ordered, seg_off, k, seg_steps)
    assert np.array_equal(m_s, r_s)
    np.testing.assert_array_equal(m_i, r_i)
    if case == "all_deleted":
        assert not np.isfinite(r_s).any() and st["pad_rows"] == mat.shape[0]
    elif k >= 512:
        assert st["pad_rows"] > 0  # pools deeper than a row's candidates


@pytest.mark.parametrize("lanes,least", [(300, 256), (24, 128), (512, 1024)])
@pytest.mark.parametrize("k", [10, 700])
def test_merge_model_decomposition(rng, lanes, least, k):
    # The decomposition at tiles and parts far smaller than the kernel's:
    # many parts a row, many tiles a part, tiles cut again after an
    # overflow, pads gathered across parts; still the reference.
    si = build_stream_index(width_segment(rng, 15, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng, 0.3)
    terms = [[0, 1, 1], [3, 3, 2], [1]] + [
        rng.integers(0, si.n_tokens, size=int(rng.integers(1, 6))).tolist() for _ in range(5)
    ]
    mat, seg_off, mt = segmented_matrix(si, terms)
    seg_steps = int(mt - 1).bit_length()
    dw, tw = _active_widths(si.w_meta[mat[mat < si.n_windows]])
    r_s, r_i = (
        np.asarray(x)
        for x in _stream_sparse(
            *ref_tables(si, s1_eff), jnp.asarray(mat), k=k, n_docs=si.n_docs,
            seg_steps=seg_steps, dwidths=dw, twidths=tw,
        )
    )
    m_s, m_i, st = stream_model(si, s1_eff, mat, seg_off, k, seg_steps, lanes=lanes, least=least)
    assert np.array_equal(m_s, r_s)
    np.testing.assert_array_equal(m_i, r_i)
    assert st["blocks"] > mat.shape[0] and st["tiles"] > st["blocks"]
    if lanes < 64:
        assert st["overflows"] > 0


def one_window_terms(si, n):
    """The first n terms whose postings fit one window."""
    span = np.diff(si.token_w_start)
    return np.flatnonzero(span == 1)[:n].tolist()


@pytest.mark.parametrize("k", [10, 2048])
def test_sparse_topk_past_a_tile_of_segments(rng, k):
    # Rows of more term occurrences than a tile has lanes (2,049 and 2,100
    # segments of one-window terms, each doc in all of them): the CPU
    # wrapper against _stream_sparse, scores bit-equal and every id equal.
    si = build_stream_index(width_segment(rng, 15, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng, 0.1)
    t0, t1, t2 = one_window_terms(si, 3)
    terms = [[t0] * (K_LANES + 1), [t1, t2] * 1050, [t0, t2]]
    mat, seg_off, mt = segmented_matrix(si, terms)
    assert seg_off.shape[1] - 1 == 2100 > K_LANES
    seg_steps = int(mt - 1).bit_length()
    dw, tw = _active_widths(si.w_meta[mat[mat < si.n_windows]])
    r_s, r_i = (
        np.asarray(x)
        for x in _stream_sparse(
            *ref_tables(si, s1_eff), jnp.asarray(mat), k=k, n_docs=si.n_docs,
            seg_steps=seg_steps, dwidths=dw, twidths=tw,
        )
    )
    assert np.isfinite(r_s).any()
    s, i = stream_sparse.stream_sparse_topk(
        *port_tensors(si, s1_eff), torch.from_numpy(mat), k, si.n_docs, seg_steps,
        torch.from_numpy(seg_off),
    )
    assert np.array_equal(s.numpy(), r_s)
    np.testing.assert_array_equal(i.numpy(), r_i)


@pytest.mark.parametrize("seg_steps", [None, 3])
@pytest.mark.parametrize("k", [10, 700])
def test_merge_model_one_doc_tiles(rng, seg_steps, k):
    # The decomposition with tiles of 24 lanes and rows of up to 60
    # segments: one-doc tiles past the tile's lanes sum their runs in
    # chunks of 24 segments (also where 2^seg_steps stops the scan inside
    # the first chunk); still the reference.
    si = build_stream_index(width_segment(rng, 15, n_docs=20_000))
    s1_eff, _ = s1_eff_of(si, rng, 0.2)
    t0, t1, t2 = one_window_terms(si, 3)
    terms = [[t0] * 60, [t1, t2] * 20, [t0, t1, 3], [t2]]
    mat, seg_off, mt = segmented_matrix(si, terms)
    steps = int(mt - 1).bit_length() if seg_steps is None else seg_steps
    dw, tw = _active_widths(si.w_meta[mat[mat < si.n_windows]])
    r_s, r_i = (
        np.asarray(x)
        for x in _stream_sparse(
            *ref_tables(si, s1_eff), jnp.asarray(mat), k=k, n_docs=si.n_docs,
            seg_steps=steps, dwidths=dw, twidths=tw,
        )
    )
    m_s, m_i, st = stream_model(si, s1_eff, mat, seg_off, k, steps, lanes=24, least=128)
    assert np.array_equal(m_s, r_s)
    np.testing.assert_array_equal(m_i, r_i)
    assert st["one_doc"] > 0


def test_segment_planning_helpers():
    cnt = np.array([3, 0, 2, 5, 1])
    qidx = np.array([0, 0, 2, 2, 3])
    off = stream_sparse.segment_offsets(cnt, qidx, np.array([2, 0, 1, 3]), 4)
    np.testing.assert_array_equal(off, [[0, 2, 7], [0, 3, 3], [0, 0, 0], [0, 1, 1]])
    assert off.dtype == np.int32
    win_ord = np.array([[0, 0, 1, 1, 1, -1], [0, 2, 2, -1, -1, -1], [-1] * 6])
    np.testing.assert_array_equal(
        stream_sparse.ordinal_offsets(win_ord), [[0, 2, 5, 5], [0, 1, 1, 3], [0, 0, 0, 0]]
    )
    got = stream_sparse.doc_ordered(np.array([9, 4, 7, 3, 2, 8]), [3, 0, 2, 1])
    np.testing.assert_array_equal(got, [4, 7, 9, 2, 3, 8])
    plan = stream_sparse.merge_plan(np.array([200, 1, 0]), 10, 132)
    rows, parts = plan >> 12, (plan >> 6) & 63
    n_parts = (plan & 63) + 1
    np.testing.assert_array_equal(rows, [0, 0, 0, 0, 1, 2])
    np.testing.assert_array_equal(parts, [0, 1, 2, 3, 0, 0])
    np.testing.assert_array_equal(n_parts, [4, 4, 4, 4, 1, 1])
    assert stream_sparse.merge_plan(np.array([10**6]), 16, 132).size == stream_sparse.MAX_BLOCKS


def test_sparse_topk_rejects_bad_segments(rng):
    si = build_stream_index(width_segment(rng, 15, n_docs=2_000))
    s1_eff, _ = s1_eff_of(si, rng)
    mat, seg_off, _ = segmented_matrix(si, [[1, 2], [3]])
    args = (*port_tensors(si, s1_eff), torch.from_numpy(mat), 10, si.n_docs, 1)
    with pytest.raises(TypeError, match="seg_off"):
        stream_sparse.stream_sparse_topk(*args, torch.from_numpy(seg_off).long())
    with pytest.raises(ValueError, match="seg_off"):
        stream_sparse.stream_sparse_topk(*args, torch.from_numpy(seg_off[:1]))
    with pytest.raises(TypeError, match="seg_off"):
        stream_sparse.stream_sparse_topk(*args)
    with pytest.raises(ValueError, match="k must"):
        stream_sparse.stream_sparse_topk(*args[:7], 0, *args[8:], torch.from_numpy(seg_off))
    with pytest.raises(ValueError, match="seg_steps"):
        stream_sparse.stream_sparse_topk(*args[:9], 31, torch.from_numpy(seg_off))


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
