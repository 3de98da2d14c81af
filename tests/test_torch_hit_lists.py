"""The facade's result lists: ``index/bm25index.py::_hit_lists`` against
the per-row construction it replaced (kept here as the oracle), and the
batch entries end to end against the per-query ``search()`` path, with
the ``hits`` and ``hit_rows_short`` counters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.index.bm25index import SearchHit, _hit_lists  # noqa: E402
from vectorchord_bm25_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)

INF = np.inf


def per_row_hits(scores, payloads):
    """One numpy row at a time: the finite lanes, each hit made by
    ``SearchHit(s, p)`` from numpy scalars."""
    out = []
    for qi in range(scores.shape[0]):
        row_s = scores[qi]
        row_p = payloads[qi]
        valid = np.isfinite(row_s)
        out.append([SearchHit(s, p) for s, p in zip(row_s[valid], row_p[valid])])
    return out


def _arrays(q, w, seed=5):
    rng = np.random.default_rng(seed)
    scores = np.sort(rng.random((q, w)).astype(np.float32), axis=1)[:, ::-1] * 20
    payloads = rng.integers(-(2**40), 2**40, size=(q, w))
    return scores.astype(np.float64), payloads.astype(np.int64)


def _full():
    return _arrays(64, 10)


def _trailing_pads():
    s, p = _arrays(64, 10)
    s[::3, 6:] = -INF
    s[1, 1:] = -INF
    return s, p


def _all_pad_row():
    s, p = _arrays(8, 10)
    s[3] = -INF
    s[7] = -INF
    return s, p


def _nan_lane():
    s, p = _arrays(8, 10)
    s[2, 4] = np.nan
    s[5, 0] = np.nan
    return s, p


def _mid_inf():
    s, p = _arrays(8, 10)
    s[0, 3] = -INF
    s[4, [0, 5, 9]] = -INF
    s[6, 1] = INF  # not finite either: drops out as today
    return s, p


def _narrow():
    s, p = _arrays(16, 3)
    s[2, 1] = -INF
    return s, p


def _zero_width():
    return _arrays(5, 0)


def _no_rows():
    return _arrays(0, 10)


CASES = {
    "full": _full,
    "trailing_pads": _trailing_pads,
    "all_pad_row": _all_pad_row,
    "nan_lane": _nan_lane,
    "mid_inf": _mid_inf,
    "narrow": _narrow,
    "zero_width": _zero_width,
    "no_rows": _no_rows,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hit_lists_match_per_row_construction(case):
    scores, payloads = CASES[case]()
    got = _hit_lists(scores, payloads)
    want = per_row_hits(scores, payloads)
    assert type(got) is list and len(got) == scores.shape[0]
    assert got == want
    for row, want_row in zip(got, want):
        assert type(row) is list
        for h, w in zip(row, want_row):
            assert type(h) is SearchHit
            assert type(h.score) is float and type(h.payload) is int
            # Bit for bit, not just equal.
            assert np.float64(h.score).tobytes() == np.float64(w.score).tobytes()
    assert len({id(row) for row in got}) == len(got)


def _docs(rng, n, vocab):
    return [
        Document.from_int_ids(rng.integers(0, vocab, size=int(rng.integers(1, 12))).tolist())
        for _ in range(n)
    ]


def _index(sealed):
    """A sealed segment of 120 docs (or none, the growing-only index) over
    a common vocabulary, 80 inserted docs, some of them over words the
    sealed segment lacks, and deletes in both segments, so some queries
    find fewer than k live docs."""
    rng = np.random.default_rng(11)
    idx = Bm25Index.build(_docs(rng, 120 if sealed else 0, 30), device="cpu")
    for j, doc in enumerate(_docs(rng, 60, 30)):
        idx.insert(doc, 1000 + j)
    for j in range(20):
        idx.insert(Document.from_int_ids([100 + j % 5, int(rng.integers(0, 30))]), 2000 + j)
    idx.bulkdelete_payloads([1000 + j for j in range(0, 60, 7)] + [2000, 2006])
    if sealed:
        idx.bulkdelete(lambda p: p % 9 == 4)
    return idx


QUERIES = (
    [Query.from_int_ids([1, 2, 3]), Query.from_int_ids([5]), Query.from_int_ids([7, 20])]
    + [Query.from_int_ids([100 + j]) for j in range(5)]
    + [Query.from_int_ids([100, 101, 4]), Query.from_int_ids([999])]
)


@pytest.mark.parametrize("entry", ["search_batch", "search_batch_async"])
@pytest.mark.parametrize("sealed", [True, False], ids=["sealed", "growing_only"])
def test_batch_entries_match_single_query_path(entry, sealed):
    idx = _index(sealed)
    k = 10
    tracing.disable()
    tracing.reset()
    tracing.enable()
    try:
        if entry == "search_batch":
            got = idx.search_batch(QUERIES, k=k)
        else:
            got = idx.search_batch_async(QUERIES, k=k)()
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    short = sum(len(row) < k for row in got)
    if sealed:
        # Some queries find fewer than k live docs, some none, some k.
        assert 0 < short < len(got) and any(not row for row in got)
    else:
        # Inserted docs score with the sealed segment's statistics: with
        # no sealed docs every score is 0, so every row is all pads.
        assert short == len(got) and not any(got)
    assert counters["hits"] == sum(len(row) for row in got)
    assert counters["hit_rows_short"] == short
    for q, row in zip(QUERIES, got):
        one = idx.search(q, k=k)
        assert [h.payload for h in row] == [h.payload for h in one]
        np.testing.assert_allclose(
            [h.score for h in row], [h.score for h in one], rtol=1e-6
        )
        assert all(type(h) is SearchHit and type(h.score) is float for h in row)
        assert all(type(h.payload) is int for h in row)
