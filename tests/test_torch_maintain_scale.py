"""``tests/test_maintain_scale.py`` replayed on the port's ``Bm25Index``
with ``device="cpu"``: the vectorized mutation path at the corpus sizes the
engines serve (``maintain``/``bulkdelete`` in seconds on a
few-hundred-thousand-doc corpus), the vectorized relabel exactly equal to
the document-by-document semantics, the ``isin`` delete path and the
scalar-predicate fallback.  Imports are rewritten and every assertion is
the reference's (each test names its engine).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index as _Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import build_sealed_segment_from_postings  # noqa: E402
from vectorchord_bm25_tpu_torch.text.intern import Document, intern_int_id, random_seed  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.options import IndexOptions  # noqa: E402

torch.set_num_threads(2)


class Bm25Index(_Bm25Index):
    """The port's facade, every index (built or constructed) on the CPU."""

    def __init__(self, *args, **kw):
        kw["device"] = "cpu"
        super().__init__(*args, **kw)


def _int_id_vocab(v: int) -> np.ndarray:
    """Vectorized intern_int_id: big-endian u32 in the first 4 key bytes."""
    buf = np.zeros((v, 16), np.uint8)
    buf[:, :4] = np.frombuffer(
        np.arange(v, dtype=">u4").tobytes(), np.uint8
    ).reshape(-1, 4)
    return buf.reshape(-1).view("S16")


def _synthetic_index(n_docs: int, vocab: int, avg_len: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = n_docs * avg_len
    tids = (rng.zipf(1.3, size=p) - 1) % vocab + 1
    docs = rng.integers(0, n_docs, size=p, dtype=np.int64)
    packed = (tids.astype(np.uint64) << np.uint64(32)) | docs.astype(np.uint64)
    packed = np.unique(packed)
    tids = (packed >> np.uint64(32)).astype(np.int64)
    docs = (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
    tfs = 1 + rng.integers(0, 4, size=tids.size, dtype=np.int64)
    keys = _int_id_vocab(vocab + 1)[tids]
    seg = build_sealed_segment_from_postings(keys, docs, tfs, n_docs)
    return Bm25Index(seg, random_seed(), IndexOptions(), engine="exact")


def test_maintain_scales_to_engine_sized_corpora():
    n = 300_000
    index = _synthetic_index(n, vocab=50_000, avg_len=25)
    n_postings = int(index.sealed.block_n.sum())

    t0 = time.time()
    deleted = index.bulkdelete(lambda p: p % 10 == 0)
    bulk_s = time.time() - t0
    assert deleted == n // 10
    # Vectorized predicate path: milliseconds, not minutes.
    assert bulk_s < 2.0, f"bulkdelete took {bulk_s:.2f}s"

    # Postings owned by deleted docs, for the conservation check below.
    tok, doc, tfv = index.sealed.postings()
    dead_postings = int(index.deleted[doc].sum())

    t0 = time.time()
    index.maintain()
    maintain_s = time.time() - t0
    assert maintain_s < 30.0, f"maintain took {maintain_s:.2f}s"

    assert index.sealed.n_docs == n - deleted
    assert not index.deleted.any()
    assert int(index.sealed.block_n.sum()) == n_postings - dead_postings
    # No deleted payload survives.
    assert not (index.sealed.doc_payload % 10 == 0).any()


def test_vectorized_maintain_matches_per_doc_semantics():
    """The packed-sort merge must replicate the reference ordering exactly:
    sealed slot order first, then growing insertion order (maintain.rs)."""
    seed = random_seed()
    rng = np.random.default_rng(1)
    docs = []
    for _ in range(200):
        terms = rng.choice(50, size=rng.integers(1, 8), replace=False)
        docs.append(
            Document(
                keys=np.sort(np.array([intern_int_id(t + 1) for t in terms], dtype="S16")),
                values=rng.integers(1, 5, size=terms.size).astype(np.uint32),
            )
        )
    index = Bm25Index.build(docs, seed=seed, engine="exact")
    # Mutations: delete a stripe, insert growing docs w/ sealed-unknown terms.
    index.bulkdelete(lambda p: p % 7 == 3)
    for i in range(20):
        terms = rng.choice(80, size=rng.integers(1, 8), replace=False)
        index.insert(
            Document(
                keys=np.sort(np.array([intern_int_id(t + 1) for t in terms], dtype="S16")),
                values=rng.integers(1, 5, size=terms.size).astype(np.uint32),
            ),
            payload=1000 + i,
        )
    index.bulkdelete(lambda p: p == 1005)

    # Expected state via the straightforward per-doc reconstruction.
    expected_docs, expected_payloads = [], []
    seg = index.sealed
    tok, doc, tfv = seg.postings()
    order = np.lexsort((tok, doc))
    tok, doc, tfv = tok[order], doc[order], tfv[order]
    bounds = np.searchsorted(doc, np.arange(seg.n_docs + 1))
    for slot in range(seg.n_docs):
        if index.deleted[slot]:
            continue
        lo, hi = bounds[slot], bounds[slot + 1]
        expected_docs.append(
            Document(keys=seg.token_keys[tok[lo:hi]], values=tfv[lo:hi].astype(np.uint32))
        )
        expected_payloads.append(int(seg.doc_payload[slot]))
    for payload, d in index.growing.live_documents():
        expected_docs.append(d)
        expected_payloads.append(payload)
    expected = Bm25Index.build(
        expected_docs, payloads=expected_payloads, seed=seed, engine="exact"
    ).sealed

    index.maintain()
    got = index.sealed
    assert got.n_docs == expected.n_docs
    np.testing.assert_array_equal(got.doc_payload, expected.doc_payload)
    np.testing.assert_array_equal(got.doc_fieldnorm, expected.doc_fieldnorm)
    np.testing.assert_array_equal(got.token_keys, expected.token_keys)
    np.testing.assert_array_equal(got.token_df, expected.token_df)
    np.testing.assert_array_equal(got.block_docids, expected.block_docids)
    np.testing.assert_array_equal(got.block_tfs, expected.block_tfs)
    np.testing.assert_array_equal(got.block_wand_fn, expected.block_wand_fn)
    np.testing.assert_array_equal(got.block_wand_tf, expected.block_wand_tf)


def test_bulkdelete_payloads_isin_path():
    index = _synthetic_index(5_000, vocab=2_000, avg_len=10)
    index.insert(
        Document(
            keys=np.array([intern_int_id(1)], dtype="S16"),
            values=np.array([2], dtype=np.uint32),
        ),
        payload=7777,
    )
    count = index.bulkdelete_payloads([10, 20, 30, 7777, 999999])
    assert count == 4  # three sealed + one growing; missing payload ignored
    assert index.deleted[[10, 20, 30]].all()
    assert index.growing.deleted[0]
    # Idempotent.
    assert index.bulkdelete_payloads([10, 7777]) == 0


def test_scalar_predicate_fallback():
    index = _synthetic_index(1_000, vocab=500, avg_len=8)

    forbidden = {3, 5, 8}

    def pred(p):
        return p in forbidden  # raises TypeError on arrays -> fallback

    assert index.bulkdelete(pred) == 3
    assert index.deleted[[3, 5, 8]].all()
