"""Port's BlockMaxEngine vs the reference's, on the same segment and RangeIndex.

The reference runs with its Pallas kernel in interpret mode; the port on
the CPU, through the plain version of its kernel.  Every f32 operation
adds in the same order, so ids and scores must be equal, not close.
Replays the cases of tests/test_blockmax.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.search.blockmax import (  # noqa: E402
    BlockMaxEngine as RefEngine,
)
from vectorchord_bm25_tpu.search.device import (  # noqa: E402
    DeviceSegment as RefDeviceSegment,
)
from vectorchord_bm25_tpu.text.intern import Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.index.ranges import (  # noqa: E402
    RangeIndex as PortRangeIndex,
)
from vectorchord_bm25_tpu_torch.index.sealed import (  # noqa: E402
    SealedSegment as PortSegment,
)
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402
from vectorchord_bm25_tpu_torch.search.device import DeviceSegment  # noqa: E402

from test_sealed import make_docs  # noqa: E402

torch.set_num_threads(2)


def engines(seg, ri=None, **kw):
    ri = ri or build_range_index(seg)
    ref = RefEngine(seg, ri, use_pallas="interpret", **kw)
    port = BlockMaxEngine(seg, ri, device="cpu", **kw)
    return ref, port


def assert_same(ref, port, queries, k, **kw):
    s1, i1, p1 = ref.search(queries, k, **kw)
    s2, i2, p2 = port.search(queries, k, **kw)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(s2, s1)
    np.testing.assert_array_equal(p2, p1)
    return i2


@pytest.mark.parametrize(
    "n_docs,vocab,range_size",
    [(200, 20, 64), (500, 8, 128), (64, 100, 32), (1000, 30, 128)],
)
def test_matches_reference(rng, n_docs, vocab, range_size):
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    ref, port = engines(seg, build_range_index(seg, range_size=range_size), chunk=4)
    queries = [
        Query.from_int_ids(rng.integers(0, vocab, size=3).tolist())
        for _ in range(6)
    ]
    for k in (1, 10):
        ids = assert_same(ref, port, queries, k)
        assert (ids >= 0).any()


def test_pruning_skips_work(rng):
    docs = make_docs(rng, 2000, vocab=5)
    docs[37] = Document.from_int_ids([0, 999])  # rare term 999
    seg = build_sealed_segment(docs)
    ri = build_range_index(seg, range_size=64)
    ref, port = engines(seg, ri, chunk=2)
    assert_same(ref, port, [Query.from_int_ids([999])], 5)
    assert port.last_rounds < -(-ri.n_ranges // 2) / 2


def test_deleted_and_filter(rng):
    seg = build_sealed_segment(make_docs(rng, 300, vocab=6))
    ref, port = engines(seg)
    deleted = np.zeros(300, dtype=bool)
    deleted[::2] = True
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    mask = np.zeros(300, dtype=bool)
    mask[100:] = True
    ids = assert_same(ref, port, [Query.from_int_ids([0, 1])], 15, filter_mask=mask)
    live = ids[ids >= 0]
    assert live.size and np.all(live % 2 == 1) and np.all(live >= 100)


def test_missing_and_empty(rng):
    seg = build_sealed_segment(make_docs(rng, 50, vocab=5))
    ref, port = engines(seg)
    queries = [
        Query.from_int_ids([999999]),
        Query(keys=np.zeros(0, dtype="S16")),
        Query.from_int_ids([0]),
    ]
    ids = assert_same(ref, port, queries, 5)
    assert np.all(ids[:2] == -1)
    with pytest.raises(ValueError):
        port.search([Query.from_int_ids([0])], 0)


def test_all_missing_batch(rng):
    seg = build_sealed_segment(make_docs(rng, 50, vocab=5))
    ref, port = engines(seg)
    assert_same(ref, port, [Query.from_int_ids([999999])] * 3, 4)


def test_multirange_terms(rng):
    seg = build_sealed_segment(make_docs(rng, 600, vocab=3, max_len=8))
    ref, port = engines(seg, build_range_index(seg, range_size=32), chunk=8)
    assert_same(ref, port, [Query.from_int_ids([0, 1, 2])], 25)


def test_k_larger_than_corpus(rng):
    seg = build_sealed_segment(make_docs(rng, 40, vocab=4))
    ref, port = engines(seg, chunk=4)
    ids = assert_same(ref, port, [Query.from_int_ids([0, 1])], 64)
    assert ids.shape == (1, 64)


def test_wide_queries(rng):
    # More than four terms: the term bucket grows to 8.
    seg = build_sealed_segment(make_docs(rng, 800, vocab=60))
    ref, port = engines(seg, build_range_index(seg, range_size=64), chunk=4)
    queries = [
        Query.from_int_ids(rng.integers(0, 60, size=7).tolist())
        for _ in range(5)
    ]
    assert_same(ref, port, queries, 10)


@pytest.mark.parametrize("with_blocks", [False, True])
def test_device_segment_matches_reference(rng, with_blocks):
    seg = build_sealed_segment(make_docs(rng, 700, vocab=30))
    deleted = rng.random(700) < 0.2
    ref = RefDeviceSegment.from_sealed(seg, deleted, with_blocks=with_blocks)
    port = DeviceSegment.from_sealed(
        seg, deleted, device="cpu", with_blocks=with_blocks
    )
    assert (port.n_docs, port.n_tokens, port.n_rows) == (
        ref.n_docs, ref.n_tokens, ref.n_rows,
    )
    for name in ("doc_live", "post_docid", "post_impact"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        )
    if with_blocks:
        np.testing.assert_array_equal(port.token_flat_start, ref.token_flat_start)
    deleted = ~deleted
    ref.set_deleted(deleted)
    port.set_deleted(deleted)
    np.testing.assert_array_equal(port.doc_live.numpy(), np.asarray(ref.doc_live))


def test_memory_report_equal(rng):
    seg = build_sealed_segment(make_docs(rng, 2000, vocab=50))
    ref, port = engines(seg)
    assert port.memory_report() == ref.memory_report()


@pytest.mark.parametrize("source", ["engine", "segment"])
def test_from_reference(rng, source):
    seg = build_sealed_segment(make_docs(rng, 400, vocab=10))
    ref = RefEngine(seg, chunk=4, use_pallas="interpret")
    deleted = rng.random(400) < 0.3
    ref.set_deleted(deleted)
    if source == "engine":
        port = BlockMaxEngine.from_reference(ref, device="cpu")
        assert port.chunk == 4
    else:
        port = BlockMaxEngine.from_reference(
            seg, ref.ranges, device="cpu", deleted=deleted
        )
    # The reference's state crosses by value, into the port's own classes.
    assert isinstance(port.ranges, PortRangeIndex)
    assert isinstance(port.segment, PortSegment)
    for f in dataclasses.fields(PortRangeIndex):
        np.testing.assert_array_equal(
            getattr(port.ranges, f.name), getattr(ref.ranges, f.name)
        )
    queries = [Query.from_int_ids([0, 1, 2]), Query.from_int_ids([3])]
    assert_same(ref, port, queries, 10)


def test_unported_options_raise(rng):
    # posting_mode="tf", bf16 impacts and the range sweep are ported now:
    # each serves equal to the reference (tests/test_torch_blockmax_rest.py
    # holds them case by case); only an unknown posting mode still raises.
    seg = build_sealed_segment(make_docs(rng, 50, vocab=5))
    queries = [Query.from_int_ids([0, 1])]
    for kw in ({"posting_mode": "tf"}, {"impact_dtype": "bfloat16"}):
        ref, port = engines(seg, **kw)
        assert_same(ref, port, queries, 5)
    ref, port = engines(seg)
    s1, i1, p1 = ref.search_rangescan_async(queries, 5)()
    s2, i2, p2 = port.search_rangescan_async(queries, 5)()
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(s2, s1)
    with pytest.raises(ValueError, match="posting_mode"):
        BlockMaxEngine(seg, device="cpu", posting_mode="bogus")
