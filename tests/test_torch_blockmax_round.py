"""The Block-Max round outside the scoring kernel (``ops/blockmax_round.py``)
on the CPU.

- The three plain versions against the torch ops they replaced in
  ``search/blockmax.py`` and against the reference's own jax ops
  (``lax.top_k``, ``lax.sort(num_keys=2)``), on seeded numpy inputs: ties in
  the bounds, -inf rows, pad terms, ``k`` above the matches, ``n_docs`` not a
  multiple of the range size, ``C == n_ranges``.
- The port's ``BlockMaxEngine`` against the reference's, with
  ``use_pallas=False`` and ``"interpret"``, on f32, bf16 and tf postings:
  ids, scores and payloads equal and ``last_rounds`` equal, tied range
  bounds included.
- The hybrid engine's ``pruned`` and one-shot routes, which run the same
  round loop with their own chunk sizes.

Tolerance: none.  Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.search.blockmax import (  # noqa: E402
    BlockMaxEngine as RefEngine,
)
from vectorchord_bm25_tpu.search.hybrid import HybridEngine as RefHybrid  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import segment_from_reference  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import blockmax_round as br  # noqa: E402
from vectorchord_bm25_tpu_torch.ops.topk import lex_topk  # noqa: E402
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.search.hybrid import HybridEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402

from test_sealed import make_docs  # noqa: E402

torch.set_num_threads(2)

INT_MAX = int(np.iinfo(np.int32).max)
NEG_INF = float("-inf")


def make_csr(rng, vocab, n_ranges, max_groups, tied=False):
    """A random (term, range) group CSR in the engine's device layout:
    ``token_tr_start`` [V+2] (the null term V has an empty span), ``tr_range``
    [M+1] ascending inside a term (pad INT_MAX), ``tr_start`` [M+2]
    contiguous posting spans (slots M and M+1 hold the total) and ``tr_ub``
    [M+1] (pad 0).  ``tied`` draws the bounds from three values."""
    counts = rng.integers(0, max_groups + 1, size=vocab)
    counts[0] = max_groups  # one term with the longest list
    counts[1] = 0  # and one in no range
    tts = np.zeros(vocab + 2, dtype=np.int32)
    tts[1 : vocab + 1] = np.cumsum(counts)
    tts[vocab + 1] = tts[vocab]
    m = int(tts[vocab])
    tr_range = np.empty(m + 1, dtype=np.int32)
    for v in range(vocab):
        tr_range[tts[v] : tts[v + 1]] = np.sort(
            rng.choice(n_ranges, size=counts[v], replace=False)
        )
    tr_range[m] = INT_MAX
    lens = rng.integers(1, 9, size=m)
    tr_start = np.zeros(m + 2, dtype=np.int32)
    tr_start[1 : m + 1] = np.cumsum(lens)
    tr_start[m + 1] = tr_start[m]
    if tied:
        ub = rng.choice(np.float32([0.5, 1.25, 3.0]), size=m)
    else:
        ub = rng.random(m, dtype=np.float32) * 4 + np.float32(1e-3)
    tr_ub = np.append(ub, np.float32(0.0)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (tts, tr_range, tr_start, tr_ub))


def make_q_tid(rng, n_q, t, vocab):
    """[Q, T] term ids with pads (V) at the tail of some rows, one row of
    pads only and one that names the group-less term 1."""
    q_tid = rng.integers(0, vocab, size=(n_q, t)).astype(np.int32)
    q_tid[0, :] = vocab
    q_tid[1, :] = [0, 1] + [vocab] * (t - 2)
    for qi in range(2, n_q, 3):
        q_tid[qi, rng.integers(1, t) :] = vocab
    return torch.from_numpy(q_tid)


def old_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax):
    """Phase 1 as ``search/blockmax.py`` ran it before B1-bounds."""
    q, t = q_tid.shape
    qt_range, _, _, qt_ub = br.term_windows(tr_range, None, tr_ub, tts, q_tid, lmax)
    safe_r = torch.where(qt_range == INT_MAX, n_ranges, qt_range).long()
    ub_work = torch.zeros((q, n_ranges + 1), dtype=torch.float32)
    for ti in range(t):
        ub_work.scatter_add_(1, safe_r[:, ti], qt_ub[:, ti])
    scale = torch.tensor(1.0 + (t + 2) * 1.2e-7, dtype=torch.float32)
    return ub_work[:, :n_ranges] * scale


def ref_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax):
    """Phase 1 as the reference states it (search/blockmax.py:82-107)."""
    tts, tr_range, tr_ub, q_tid = (jnp.asarray(x.numpy()) for x in (tts, tr_range, tr_ub, q_tid))
    q, t = q_tid.shape
    m_pad = tr_range.shape[0] - 1
    base = tts[q_tid]
    count = tts[q_tid + 1] - base
    l_iota = jax.lax.broadcasted_iota(jnp.int32, (q, t, lmax), 2)
    widx = jnp.minimum(base[..., None] + l_iota, m_pad)
    lmask = l_iota < count[..., None]
    flat_r = jnp.where(lmask, tr_range[widx], INT_MAX).reshape(q, t * lmax)
    flat_u = jnp.where(lmask, tr_ub[widx], 0.0).reshape(q, t * lmax)
    safe_r = jnp.where(flat_r == INT_MAX, n_ranges, flat_r)
    ub = jax.vmap(
        lambda r, u: jnp.zeros(n_ranges + 1, dtype=jnp.float32).at[r].add(u)
    )(safe_r, flat_u)[:, :n_ranges]
    return np.asarray(ub * np.float32(1.0 + (t + 2) * 1.2e-7))


@pytest.mark.parametrize("t", [4, 8])
@pytest.mark.parametrize("tied", [False, True])
def test_range_bounds_equals_replaced_ops_and_reference(rng, t, tied):
    vocab, n_ranges, lmax = 30, 37, 16
    tts, tr_range, _, tr_ub = make_csr(rng, vocab, n_ranges, 11, tied=tied)
    q_tid = make_q_tid(rng, 20, t, vocab)
    got = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax)
    assert got.shape == (20, n_ranges) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert torch.equal(got, old_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax))
    np.testing.assert_array_equal(
        got.numpy(), ref_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax)
    )
    assert not got[0].any()  # the all-pad query bounds nothing
    assert (got >= 0).all()


@pytest.mark.parametrize("t", [4, 8])
def test_range_bounds_at_16384_ranges_equals_reference(rng, t):
    # Phase (s)'s row width (a 64 KB row a query on the card), terms with up
    # to 1,500 groups each.
    vocab, n_ranges, lmax = 12, 16384, 1500
    tts, tr_range, _, tr_ub = make_csr(rng, vocab, n_ranges, lmax)
    q_tid = make_q_tid(rng, 6, t, vocab)
    got = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax)
    assert got.shape == (6, n_ranges)
    assert torch.equal(got, old_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax))
    np.testing.assert_array_equal(
        got.numpy(), ref_bounds(tts, tr_range, tr_ub, q_tid, n_ranges, lmax)
    )
    assert (got[2:] > 0).any(axis=1).all()


def select_case(rng, case, n_q=24, t=4, vocab=30, n_ranges=37, k=5):
    """Inputs of one B1-select call: bounds with ties, rows that are partly
    or wholly taken (-inf), thresholds above some rows' maxima."""
    csr = make_csr(rng, vocab, n_ranges, 11, tied=True)
    tts, tr_range, tr_start, tr_ub = csr
    q_tid = make_q_tid(rng, n_q, t, vocab)
    ub = br.range_bounds(tts, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=16)
    topk_s = torch.full((n_q, k), NEG_INF)
    if case == "first round":
        pass
    elif case == "partly taken":
        taken = torch.from_numpy(rng.random((n_q, n_ranges)) < 0.8)
        ub = torch.where(taken, NEG_INF, ub)
        ub[3] = NEG_INF  # nothing left at all
    elif case == "thresholds":
        # Some rows' kth score is above every bound (inactive), some
        # between bounds (a prefix of the candidates is ok), some ties.
        kth = torch.from_numpy(rng.choice(np.float32([0.0, 0.5, 1.25, 3.0, 50.0]), size=n_q))
        topk_s = (kth[:, None] + torch.arange(k - 1, -1, -1)).float()
        topk_s[5] = NEG_INF
    elif case == "boundary ties":
        # Equal bounds straddle the C-th place of every chunk tested (two at
        # 9.0, twenty at 5.0, the rest lower); one row has fewer live bounds
        # than C, so it refills with its lowest -inf ranges.
        vals = rng.choice(np.float32([0.0, 0.5, 1.25]), size=(n_q, n_ranges))
        for qi in range(n_q):
            pos = rng.permutation(n_ranges)
            vals[qi, pos[:2]] = 9.0
            vals[qi, pos[2:22]] = 5.0
        ub = torch.from_numpy(vals)
        ub[3] = NEG_INF  # nothing left at all
        ub[7] = NEG_INF
        ub[7, 10:13] = 5.0  # three live bounds
    return csr, q_tid, ub.contiguous(), topk_s


def old_select(ub_work, topk_s, tr_range, tr_start, tts, q_tid, chunk, lmax):
    """The round's head as ``search/blockmax.py`` ran it before B1-select,
    with its top-k pinned to the reference's tie rule (a stable argsort of
    the negated bounds: higher bound first, lower range at equal bounds)."""
    thresh = topk_s[:, -1].clamp_min(0.0)
    active = ub_work.amax(dim=1) > thresh
    order = np.argsort(-ub_work.numpy(), axis=1, kind="stable")[:, :chunk]
    cand_r = torch.from_numpy(order)
    cand_ub = ub_work.gather(1, cand_r)
    ub_next = ub_work.scatter(1, cand_r, NEG_INF)
    cand_ok = cand_ub > thresh[:, None]
    cand_r = cand_r.int()
    qt_range, qt_start, qt_len, _ = br.term_windows(
        tr_range, tr_start, None, tts, q_tid, lmax
    )
    start, length = br.locate(qt_range, qt_start, qt_len, cand_r, lmax, cand_ok)
    return active, cand_r, ub_next, start, length


@pytest.mark.parametrize("chunk", [1, 4, 37])
@pytest.mark.parametrize(
    "case", ["first round", "partly taken", "thresholds", "boundary ties"]
)
def test_round_select_equals_replaced_ops_and_reference(rng, case, chunk):
    (tts, tr_range, tr_start, _), q_tid, ub, topk_s = select_case(rng, case)
    before = ub.clone()
    active, want_r, want_ub, want_start, want_len = old_select(
        before, topk_s, tr_range, tr_start, tts, q_tid, chunk, 16
    )
    cand_r, start, length, flag = br.round_select(
        ub, topk_s, tr_range, tr_start, tts, q_tid, chunk=chunk, lmax=16
    )
    assert cand_r.dtype == start.dtype == length.dtype == flag.dtype == torch.int32
    assert cand_r.shape == (24, chunk) and start.shape == length.shape == (24, 4, chunk)
    assert bool(flag) == bool(active.any())
    assert active.any() and (case == "first round" or not active.all())
    # The reference's own selection: lax.top_k takes the lower index at a tie.
    _, ref_r = jax.lax.top_k(jnp.asarray(before.numpy()), chunk)
    np.testing.assert_array_equal(cand_r[active].numpy(), np.asarray(ref_r)[active.numpy()])
    # Active queries: every output is the replaced ops'.
    assert torch.equal(cand_r[active], want_r[active])
    assert torch.equal(ub[active], want_ub[active])
    assert torch.equal(start[active], want_start[active])
    assert torch.equal(length[active], want_len[active])
    # Inactive queries: no work for the scoring kernel (as the replaced ops
    # say), cand_r 0, the row untouched.
    idle = ~active
    assert not want_len[idle].any()
    assert not length[idle].any() and not start[idle].any() and not cand_r[idle].any()
    assert torch.equal(ub[idle], before[idle])
    # A span is reported only for a candidate above the threshold.
    thresh = topk_s[:, -1].clamp_min(0.0)
    ok = before.gather(1, cand_r.long()) > thresh[:, None]
    assert not length.permute(0, 2, 1)[~ok].any()


def test_round_select_flag_and_argument_checks(rng):
    (tts, tr_range, tr_start, _), q_tid, ub, topk_s = select_case(rng, "first round")
    args = (ub, topk_s, tr_range, tr_start, tts, q_tid)
    flags = torch.zeros(3, dtype=torch.int32)
    out = br.round_select(*args, chunk=4, lmax=16, flag=flags[1:2])
    assert flags.tolist() == [0, 1, 0] and out[3].data_ptr() == flags[1:2].data_ptr()
    # Every bound taken: no query is active and the flag stays 0.
    ub.fill_(NEG_INF)
    assert not bool(br.round_select(*args, chunk=4, lmax=16)[3])
    for chunk in (0, 38):
        with pytest.raises(ValueError, match="chunk"):
            br.round_select(*args, chunk=chunk, lmax=16)
    with pytest.raises(TypeError, match="ub_work"):
        br.round_select(ub.double(), *args[1:], chunk=4, lmax=16)
    with pytest.raises(ValueError, match="contiguous"):
        br.round_select(ub.t().contiguous().t(), *args[1:], chunk=4, lmax=16)
    with pytest.raises(ValueError, match="flag"):
        br.round_select(*args, chunk=4, lmax=16, flag=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="q_tid"):
        br.range_bounds(tts, tr_range, tr_start.float(), q_tid.long(), n_ranges=37, lmax=16)


def merge_case(rng, n_q, c, rs, n_docs, k, n_ranges):
    """One round's scores: distinct candidate ranges a query (the last range
    reaches past ``n_docs`` where it is not a multiple of ``rs``), mostly
    zero scores with ties among the rest, deletes and a filter."""
    cand_r = np.stack([rng.permutation(n_ranges)[:c] for _ in range(n_q)]).astype(np.int32)
    acc = rng.choice(np.float32([0.0, 0.0, 0.0, 0.75, 1.5, 2.25]), size=(n_q, c, rs))
    acc[0] = 0.0  # a query that matches nothing
    acc[1, :, 1:] = 0.0  # and one with fewer matches than k
    live = (rng.random(n_docs + 1) < 0.8).astype(np.float32)
    filt = (rng.random(n_docs + 1) < 0.7).astype(np.float32)
    live[n_docs] = filt[n_docs] = 1.0
    return tuple(torch.from_numpy(x) for x in (acc, cand_r, live, filt))


def old_merge(acc, cand_r, doc_live, filter_mask, topk_s, topk_d, n_docs):
    """The round's tail as ``search/blockmax.py`` ran it before B1-merge."""
    q, c, rs = acc.shape
    rs_iota = torch.arange(rs, dtype=torch.int32)
    cand_docs = cand_r[:, :, None] * rs + rs_iota
    cand_docs_c = cand_docs.clamp_max(n_docs).long()
    acc = acc * doc_live[cand_docs_c] * filter_mask[cand_docs_c]
    flat_s, flat_d = acc.reshape(q, c * rs), cand_docs.reshape(q, c * rs)
    ok = (flat_s > 0.0) & (flat_d < n_docs)
    flat_s = torch.where(ok, flat_s, NEG_INF)
    flat_d = torch.where(ok, flat_d, INT_MAX)
    all_s = torch.cat([topk_s, flat_s], dim=1)
    all_d = torch.cat([topk_d, flat_d], dim=1)
    # The reference's merge itself (search/blockmax.py:212-215).
    neg, d_sorted = jax.lax.sort(
        (-jnp.asarray(all_s.numpy()), jnp.asarray(all_d.numpy())), num_keys=2
    )
    k = topk_s.shape[1]
    return lex_topk(all_s, all_d, k), (-np.asarray(neg)[:, :k], np.asarray(d_sorted)[:, :k])


@pytest.mark.parametrize(
    "c,rs,n_docs,k",
    [(3, 32, 300, 8), (2, 64, 64 * 5 - 9, 16), (5, 16, 80, 64), (1, 128, 1000, 1)],
)
def test_round_merge_equals_replaced_ops_and_reference(rng, c, rs, n_docs, k):
    n_q = 9
    n_ranges = -(-n_docs // rs)
    topk_s = torch.full((n_q, k), NEG_INF)
    topk_d = torch.full((n_q, k), INT_MAX, dtype=torch.int32)
    unseen = [rng.permutation(n_ranges) for _ in range(n_q)]
    for round_no in range(n_ranges // c):
        acc, _, live, filt = merge_case(rng, n_q, c, rs, n_docs, k, n_ranges)
        # Every range is scored in one round only.
        cand_r = torch.from_numpy(
            np.stack([u[round_no * c : (round_no + 1) * c] for u in unseen]).astype(np.int32)
        )
        (want_s, want_d), (ref_s, ref_d) = old_merge(
            acc, cand_r, live, filt, topk_s, topk_d, n_docs
        )
        out_s, out_d = br.round_merge(acc, cand_r, live, filt, topk_s, topk_d, n_docs=n_docs)
        assert out_s.data_ptr() == topk_s.data_ptr()  # in place
        assert out_d.data_ptr() == topk_d.data_ptr()
        assert torch.equal(topk_s, want_s) and torch.equal(topk_d, want_d)
        np.testing.assert_array_equal(topk_s.numpy(), ref_s)
        np.testing.assert_array_equal(topk_d.numpy(), ref_d)
    assert topk_d.dtype == torch.int32
    # Pads stay (-inf, INT_MAX) through every merge; hits are live docs
    # below n_docs, (score desc, doc asc).
    pad = ~torch.isfinite(topk_s)
    assert pad[0].all() and (topk_d[pad] == INT_MAX).all()
    assert (~pad).any() and (k < 64 or pad[2:].any())  # k above the matches
    assert (topk_d[~pad] < n_docs).all() and (topk_s[~pad] > 0).all()
    key = topk_s.double() * -1e6 + topk_d.double()
    assert (key[:, 1:][~pad[:, 1:]] > key[:, :-1][~pad[:, 1:]]).all()


@pytest.mark.parametrize("k", [1, 16, 32, 33])
def test_round_merge_keeps_top_k_of_rows_that_cannot_score(rng, k):
    # The kernel skips a lane whose acc is +-0 or NaN before its gathers, and
    # a query of such lanes altogether: (acc * live) * filter is then +-0 or
    # NaN whatever live and filter hold (negative, infinite and NaN entries
    # here), never > 0.  The reference's merge keeps such a query's running
    # top-k as it was; lanes beside them still score.
    n_q, c, rs, n_docs = 8, 4, 32, 1000
    n_ranges = -(-n_docs // rs)
    values = np.float32([1.0, 1.0, 0.0, -1.0, np.inf, -np.inf, np.nan])
    live = torch.from_numpy(rng.choice(values, size=n_docs + 1))
    filt = torch.from_numpy(rng.choice(values, size=n_docs + 1))
    topk_s = torch.full((n_q, k), NEG_INF)
    topk_d = torch.full((n_q, k), INT_MAX, dtype=torch.int32)
    unseen = [rng.permutation(n_ranges) for _ in range(n_q)]
    for round_no in range(2):
        cand_r = torch.from_numpy(
            np.stack([u[round_no * c : (round_no + 1) * c] for u in unseen]).astype(np.int32)
        )
        acc = rng.choice(np.float32([0.0, 0.75, -1.5, 2.25]), size=(n_q, c, rs))
        if round_no == 1:
            acc[0] = 0.0
            acc[1] = -0.0
            acc[2] = np.nan
            acc[3] = np.where(rng.random((c, rs)) < 0.5, np.float32(0.0), np.float32(np.nan))
        acc = torch.from_numpy(acc.astype(np.float32))
        (want_s, want_d), (ref_s, ref_d) = old_merge(
            acc, cand_r, live, filt, topk_s, topk_d, n_docs
        )
        before_s, before_d = topk_s.clone(), topk_d.clone()
        br.round_merge(acc, cand_r, live, filt, topk_s, topk_d, n_docs=n_docs)
        assert torch.equal(topk_s, want_s) and torch.equal(topk_d, want_d)
        np.testing.assert_array_equal(topk_s.numpy(), ref_s)
        np.testing.assert_array_equal(topk_d.numpy(), ref_d)
        if round_no == 1:
            assert torch.equal(topk_s[:4], before_s[:4]) and torch.equal(topk_d[:4], before_d[:4])
            assert not torch.equal(topk_d[4:], before_d[4:])
    assert (topk_s[:4] > 0).any()  # the skipped rows held hits (+inf among them)


def test_round_merge_argument_checks(rng):
    acc, cand_r, live, filt = merge_case(rng, 4, 2, 16, 100, 4, 7)
    topk_s = torch.full((4, 4), NEG_INF)
    topk_d = torch.full((4, 4), INT_MAX, dtype=torch.int32)
    with pytest.raises(TypeError, match="topk_d"):
        br.round_merge(acc, cand_r, live, filt, topk_s, topk_d.long(), n_docs=100)
    with pytest.raises(ValueError, match="cand_r"):
        br.round_merge(acc, cand_r[:, :1].contiguous(), live, filt, topk_s, topk_d, n_docs=100)
    with pytest.raises(ValueError, match="entries"):
        br.round_merge(acc, cand_r, live[:50].contiguous(), filt, topk_s, topk_d, n_docs=100)


# --- the engine against the reference's, last_rounds included

MODES = {
    "f32": {},
    "bf16": {"impact_dtype": "bfloat16"},
    "tf": {"posting_mode": "tf"},
}


def assert_engines_equal(ref, port, queries, k, **kw):
    want = ref.search(queries, k, **kw)
    got = port.search(queries, k, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port.last_rounds == ref.last_rounds
    return got


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_equals_reference(rng, mode, use_pallas):
    n_docs = 5 * 64 - 11  # the last range reaches past n_docs
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=25))
    ri = build_range_index(seg, range_size=64)
    ref = RefEngine(seg, ri, chunk=2, use_pallas=use_pallas, **MODES[mode])
    port = BlockMaxEngine(seg, ri, chunk=2, device="cpu", **MODES[mode])
    queries = [
        Query.from_int_ids(rng.integers(0, 25, size=int(n)).tolist())
        for n in rng.integers(1, 7, size=10)
    ] + [Query.from_int_ids([10**6]), Query(keys=np.zeros(0, dtype="S16"))]
    for k in (1, 10, 400):  # 400: k above every query's matches
        ids = assert_engines_equal(ref, port, queries, k)[1]
        assert (ids >= 0).any() and port.last_rounds >= 1
    deleted = rng.random(n_docs) < 0.3
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    fmask = rng.random(n_docs) < 0.6
    assert_engines_equal(ref, port, queries, 10, filter_mask=fmask)
    # One round over every range: C == n_ranges.
    assert_engines_equal(ref, port, queries, 10, chunk=ri.n_ranges)
    assert port.last_rounds == 1


def tied_corpus(first):
    """Two ranges of 32 docs whose bounds for the query [0, 1] tie exactly:
    range ``first`` holds one doc with term 0 and another with term 1 (its
    bound is reached by no doc), the other range one doc with both.  Every
    doc has two tokens, so every impact of a term is the same."""
    split = [Document.from_int_ids([0, 2]), Document.from_int_ids([1, 2])]
    both = [Document.from_int_ids([0, 1])]
    filler = Document.from_int_ids([2, 3])
    blocks = [split + [filler] * 30, both + [filler] * 31]
    if first == "both":
        blocks.reverse()
    return blocks[0] + blocks[1] + [filler] * 64


@pytest.mark.parametrize("first", ["split", "both"])
def test_tied_ranges_go_lower_first(first, monkeypatch):
    # Two ranges with exactly equal bounds, chunk 1: the round takes the
    # lower range first (lax.top_k's rule), whichever of the two it is, and
    # the round count equals the reference's.  (A bound carries a safety
    # pad, so no score reaches it: a tied range is always visited, and the
    # tie order shows in the candidates, not in the count.)
    from vectorchord_bm25_tpu_torch.search import blockmax

    seg = build_sealed_segment(tied_corpus(first))
    ri = build_range_index(seg, range_size=32)
    ref = RefEngine(seg, ri, chunk=1, use_pallas=False)
    port = BlockMaxEngine(seg, ri, chunk=1, device="cpu")
    g0, g1 = (ri.token_tr_start[seg.lookup_tokens(Query.from_int_ids([t]).keys)[0]] for t in (0, 1))
    bounds = ri.tr_ub[g0 : g0 + 2] + ri.tr_ub[g1 : g1 + 2]
    assert bounds[0] == bounds[1]
    taken = []
    real = blockmax.round_select

    def record(*args, **kw):
        out = real(*args, **kw)
        taken.append(out[0].flatten().tolist())
        return out

    monkeypatch.setattr(blockmax, "round_select", record)
    assert_engines_equal(ref, port, [Query.from_int_ids([0, 1])], 1)
    assert port.last_rounds == 2
    assert taken[:2] == [[0], [1]]


def test_last_rounds_equal_on_tied_bounds(rng):
    # Few distinct docs, so whole runs of ranges carry equal bounds.
    shapes = [[0, 1], [0, 2], [1, 2], [0, 1, 2], [3], [0, 3]]
    docs = [Document.from_int_ids(shapes[i]) for i in rng.integers(0, len(shapes), size=700)]
    seg = build_sealed_segment(docs)
    ri = build_range_index(seg, range_size=32)
    queries = [Query.from_int_ids(ids) for ids in ([0, 1], [2], [0, 1, 2, 3], [3, 1])]
    for chunk in (1, 3, 8):
        ref = RefEngine(seg, ri, chunk=chunk, use_pallas=False)
        port = BlockMaxEngine(seg, ri, chunk=chunk, device="cpu")
        for k in (1, 5, 40):
            assert_engines_equal(ref, port, queries, k)
            assert 1 <= port.last_rounds <= -(-ri.n_ranges // chunk) + 1


@pytest.mark.parametrize("memory_mode", ["fast", "compact"])
def test_hybrid_pruned_and_oneshot_routes_unchanged(rng, memory_mode):
    # The hybrid engine's one-shot buckets (chunk 8, 32, ... up to every
    # range) and its pruned heavy group run the same round loop.
    docs = make_docs(rng, 400, vocab=40)
    for i in range(0, 400, 2):
        docs[i] = Document.from_int_ids([0] + rng.integers(1, 40, size=5).tolist())
    docs[3] = Document.from_int_ids([1000, 1001])
    seg = build_sealed_segment(docs)
    opts = {
        "heavy_mode": "pruned", "memory_mode": memory_mode, "oneshot_cap": 2,
        "route_threshold": 0.10, "chunk": 4, "use_pallas": "interpret",
    }
    ref = RefHybrid(seg, **opts)
    port = HybridEngine(segment_from_reference(seg), device="cpu", **opts)
    queries = [
        Query.from_int_ids([0]), Query.from_int_ids([0, 17]),
        Query.from_int_ids([1000]), Query.from_int_ids([1000, 1001]),
        Query.from_int_ids([17]), Query.from_int_ids([999999]),
    ]
    routes = port._route(*batch_lookup(port.segment.lookup_tokens, queries), len(queries))[0].tolist()
    assert 0 in routes and 2 in routes
    for g, w in zip(port.search(queries, 15), ref.search(queries, 15)):
        np.testing.assert_array_equal(g, w)
