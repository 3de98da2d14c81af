"""The port's out-of-core build (``parallel/hostbuild.py``,
``index/streamflush.py``) against the reference's and against its own
in-core build: ``tests/test_streambuild.py`` and ``tests/test_hostbuild.py``
replayed on the port.

- the streaming flush equals the in-core flush and the reference's
  streaming flush for any chunk size;
- ``build_out_of_core`` with 1, 2 and 3 workers, bounded runs and cascaded
  merges gives a ``SealedSegment`` whose arrays equal the reference's
  out-of-core build of the same texts and the port's in-core build;
- the spawned workers import no torch (nor jax, nor the reference);
- peak RSS of the streaming flush stays O(segment + chunk), in a
  subprocess with torch, jax and the reference blocked;
- bound queries and ``search_all`` on the port's facade.

Tolerance: exact equality everywhere.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index import streamflush as ref_streamflush  # noqa: E402
from vectorchord_bm25_tpu.parallel import hostbuild as ref_hostbuild  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index, BoundQuery  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import (  # noqa: E402
    SealedSegment,
    build_sealed_segment,
)
from vectorchord_bm25_tpu_torch.index.streamflush import (  # noqa: E402
    REC_DTYPE,
    build_sealed_segment_streaming,
)
from vectorchord_bm25_tpu_torch.native import loader  # noqa: E402
from vectorchord_bm25_tpu_torch.parallel import hostbuild  # noqa: E402
from vectorchord_bm25_tpu_torch.parallel.hostbuild import build_out_of_core  # noqa: E402
from vectorchord_bm25_tpu_torch.text.corpus import documents_from_texts  # noqa: E402
from vectorchord_bm25_tpu_torch.text.intern import Document, Query  # noqa: E402

from test_sealed import make_docs as make_ref_docs  # noqa: E402
from test_streambuild import _RSS_SCRIPT  # noqa: E402
from test_torch_text import no_native  # noqa: E402
from torch_free_source import TorchFreeSource, texts as source_texts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = bytes(range(7, 39))

TEXTS = [
    "PostgreSQL is a powerful database system",
    "full text search with ranking quality",
    "BM25 ranking for search engines",
    "the PostgreSQL community improves the database",
    "vector search and keyword search combine well",
    "index structures accelerate query processing",
    "compression reduces index memory footprint",
    "relevance scoring uses idf and term frequency",
] * 5  # 40 docs


def make_docs(rng, n, vocab):
    return [Document(keys=d.keys, values=d.values) for d in make_ref_docs(rng, n, vocab=vocab)]


def assert_identical(a, b):
    """Every field of two segments, the port's or the reference's."""
    assert type(a) is SealedSegment
    assert (a.options.k1, a.options.b) == (b.options.k1, b.options.b)
    for f in dataclasses.fields(SealedSegment):
        if f.name == "options":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def write_sorted_records(path, docs):
    keys = np.concatenate([d.keys for d in docs])
    doc_of = np.repeat(np.arange(len(docs), dtype=np.int64), [len(d) for d in docs])
    tfs = np.concatenate([d.values for d in docs]).astype(np.uint32)
    order = np.lexsort((doc_of, keys))
    rec = np.zeros(keys.size, dtype=REC_DTYPE)
    rec["key"], rec["doc"], rec["tf"] = keys[order], doc_of[order], tfs[order]
    rec.tofile(path)


class TestStreamingFlush:
    @pytest.mark.parametrize("chunk", [7, 100, 1_000_000])
    def test_equals_incore_and_reference(self, rng, tmp_path, chunk):
        docs = make_docs(rng, 300, vocab=40)
        path = str(tmp_path / "merged")
        write_sorted_records(path, docs)
        payloads = np.arange(300, dtype=np.int64) * 3 + 1
        streamed = build_sealed_segment_streaming(path, 300, payloads=payloads, chunk_postings=chunk)
        assert_identical(streamed, build_sealed_segment(docs, payloads=payloads))
        assert_identical(
            streamed,
            ref_streamflush.build_sealed_segment_streaming(
                path, 300, payloads=payloads, chunk_postings=chunk
            ),
        )

    def test_empty_and_no_postings(self, tmp_path):
        path = str(tmp_path / "merged")
        open(path, "wb").close()
        seg = build_sealed_segment_streaming(path, 5)
        assert seg.n_docs == 5 and seg.n_tokens == 0
        assert_identical(seg, ref_streamflush.build_sealed_segment_streaming(path, 5))


class TestOutOfCoreBuild:
    @pytest.mark.parametrize("n_workers", [1, 2, 3])
    def test_matches_reference_and_in_memory(self, n_workers):
        oc = build_out_of_core(TEXTS, SEED, n_workers=n_workers)
        assert_identical(oc, build_sealed_segment(documents_from_texts(SEED, TEXTS)))
        assert_identical(oc, ref_hostbuild.build_out_of_core(TEXTS, SEED, n_workers=n_workers))

    @pytest.mark.parametrize("native", [True, False])
    def test_multiple_runs_match_in_memory(self, monkeypatch, native):
        # A tiny run budget forces many spilled runs a worker; the native
        # merge and the numpy merge give the same segment.
        if native:
            assert loader.available(), loader.BUILD_ERROR
        else:
            no_native(monkeypatch)
        texts = [f"token{i % 17} shared word{i % 5} filler text number {i}" for i in range(200)]
        payloads = np.arange(200, dtype=np.int64)[::-1] * 11
        loader.MERGES = 0
        oc = build_out_of_core(
            texts, SEED, payloads=payloads, n_workers=2, run_budget=1024, flush_chunk=97
        )
        assert loader.MERGES == (1 if native else 0)
        assert_identical(oc, build_sealed_segment(documents_from_texts(SEED, texts), payloads=payloads))
        assert_identical(
            oc,
            ref_hostbuild.build_out_of_core(
                texts, SEED, payloads=payloads, n_workers=2, run_budget=1024, flush_chunk=97
            ),
        )

    def test_cascaded_merge(self, monkeypatch):
        texts = [f"alpha beta{i % 13} gamma{i % 7} delta" for i in range(150)]
        monkeypatch.setattr(hostbuild, "MERGE_FAN_IN", 2)
        calls = []
        real = hostbuild._merge_group
        monkeypatch.setattr(hostbuild, "_merge_group", lambda g, out: (calls.append(len(g)), real(g, out)))
        loader.MERGES = 0
        oc = build_out_of_core(texts, SEED, n_workers=3, run_budget=1024)
        assert len(calls) > 2 and max(calls) <= 2
        assert loader.MERGES == len(calls)
        assert_identical(oc, build_sealed_segment(documents_from_texts(SEED, texts)))
        monkeypatch.setattr(ref_hostbuild, "MERGE_FAN_IN", 2)
        assert_identical(oc, ref_hostbuild.build_out_of_core(texts, SEED, n_workers=3, run_budget=1024))

    def test_callable_source(self):
        oc = build_out_of_core(_source, SEED, n_workers=1, n_docs=80, run_budget=2048)
        texts = _source(0, 80)
        assert_identical(oc, build_sealed_segment(documents_from_texts(SEED, texts)))
        assert_identical(
            oc, ref_hostbuild.build_out_of_core(_source, SEED, n_workers=1, n_docs=80, run_budget=2048)
        )

    def test_spawned_workers_import_no_torch(self):
        # The source raises in any process that has loaded torch, jax or
        # the reference; two spawned workers call it.
        assert "torch" in sys.modules  # this process has, so n_workers=1 would raise
        with pytest.raises(RuntimeError, match="a build worker loaded"):
            build_out_of_core(TorchFreeSource(9), SEED, n_workers=1, n_docs=10)
        oc = build_out_of_core(TorchFreeSource(9), SEED, n_workers=2, n_docs=300, run_budget=4096)
        want = build_sealed_segment(documents_from_texts(SEED, source_texts(9, 0, 300)))
        assert_identical(oc, want)


def _source(lo, hi):
    return [f"stream source doc{i % 11} word{i % 3}" for i in range(lo, hi)]


def test_rss_stays_bounded(tmp_path):
    """The port's streaming flush of a larger-than-chunk record file, in a
    subprocess with torch, jax and the reference blocked: peak RSS stays
    O(segment + chunk), not O(records)."""
    script = _RSS_SCRIPT.format(repo=REPO).replace(
        "from vectorchord_bm25_tpu.index.streamflush import",
        "for _m in ('torch', 'jax', 'vectorchord_bm25_tpu'):\n"
        "    sys.modules[_m] = None\n"
        "from vectorchord_bm25_tpu_torch.index.streamflush import",
    )
    assert "vectorchord_bm25_tpu_torch.index.streamflush" in script
    r = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "rec"), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr


class TestBoundQuery:
    def test_wrong_index_rejected(self, rng):
        docs = make_docs(rng, 10, vocab=5)
        a = Bm25Index.build(docs, device="cpu")
        b = Bm25Index.build(docs, device="cpu")
        qa = a.make_query(["token"])
        assert isinstance(qa, BoundQuery)
        a.search(qa, k=5)
        with pytest.raises(ValueError, match="another index"):
            b.search(qa, k=5)

    def test_bound_query_scores(self):
        docs = documents_from_texts(SEED, TEXTS[:8])
        index = Bm25Index.build(docs, seed=SEED, device="cpu")
        hits = index.search(index.make_query(["postgresql"]), k=5)
        assert len(hits) == 2


class TestSearchAll:
    def test_all_matches_returned(self, rng):
        docs = make_docs(rng, 100, vocab=4)
        index = Bm25Index.build(docs, device="cpu")
        q = Query.from_int_ids([0])
        all_hits = index.search_all(q)
        df = int(index.sealed.token_df[index.sealed.lookup_tokens(q.keys)[0]])
        assert len(all_hits) == df
        scores = [h.score for h in all_hits]
        assert scores == sorted(scores, reverse=True)
        assert [h.payload for h in index.search(q, k=-1)] == [h.payload for h in all_hits]

    def test_includes_growing(self, rng):
        index = Bm25Index.build(make_docs(rng, 10, vocab=4), device="cpu")
        index.insert(Document.from_int_ids([0, 0]), payload=777)
        assert any(h.payload == 777 for h in index.search_all(Query.from_int_ids([0])))
