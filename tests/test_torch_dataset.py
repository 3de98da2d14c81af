"""The port's dataset harness (``vectorchord_bm25_tpu_torch/data``) against
the reference's: ``tests/test_dataset.py`` replayed on the port, served on
the CPU (``device="cpu"``, the kernels' plain versions).

- the BEIR loader round trip and a directory laid out by hand;
- the generators: ``dataset_fingerprint`` of ``generate_beir_like`` equals
  the reference's (and its pinned values), ``StreamDocSource(lo, hi)``
  texts and ``generate_streaming``'s queries and qrels equal the
  reference's on ``msmarco-mini``'s first blocks;
- the metrics against hand-computed values and the reference's;
- ``run_dataset`` on ``scifact-mini`` gives the reference's run dict and
  metrics (engines stream, blockmax and exact; the reference on the JAX
  CPU backend), through ``build_index`` and ``build_index_streaming``;
- SURVEY M2: ``oracle_rank_parity`` is 0 on the full query set.

``tests/test_dataset.py::TestBenchDatasetMode::test_bench_dataset_json_line``
has no counterpart here: it drives ``bench.py``, and a benchmark of the
port is ROADMAP queue 1 item 3's.

Tolerance: exact equality (metrics compared as floats for equality).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.data import harness as ref_harness  # noqa: E402
from vectorchord_bm25_tpu.data import metrics as ref_metrics  # noqa: E402
from vectorchord_bm25_tpu.data import stream_synth as ref_stream_synth  # noqa: E402
from vectorchord_bm25_tpu.data import synthetic as ref_synthetic  # noqa: E402
from vectorchord_bm25_tpu_torch.data import (  # noqa: E402
    BeirDataset,
    generate_beir_like,
    load_beir,
    ndcg_at_k,
    recall_at_k,
)
from vectorchord_bm25_tpu_torch.data.harness import (  # noqa: E402
    build_index,
    build_index_streaming,
    make_queries,
    oracle_rank_parity,
    run_dataset,
)
from vectorchord_bm25_tpu_torch.data.metrics import evaluate_run  # noqa: E402
from vectorchord_bm25_tpu_torch.data.stream_synth import (  # noqa: E402
    STREAM_SHAPES,
    StreamDocSource,
    generate_streaming,
)
from vectorchord_bm25_tpu_torch.data.synthetic import dataset_fingerprint  # noqa: E402
from vectorchord_bm25_tpu_torch.index.bm25index import Bm25Index  # noqa: E402

from torch_free_source import TextsSource  # noqa: E402

torch.set_num_threads(2)

SEED = bytes(range(100, 132))


@pytest.fixture(scope="module")
def mini():
    return generate_beir_like("scifact-mini", seed=0)


class TestLoader:
    def test_roundtrip(self, mini, tmp_path):
        d = str(tmp_path / "ds")
        mini.save(d)
        back = load_beir(d)
        assert type(back) is BeirDataset
        assert back.doc_ids == mini.doc_ids
        assert back.doc_texts == mini.doc_texts
        assert back.query_ids == mini.query_ids
        assert back.query_texts == mini.query_texts
        assert back.qrels == mini.qrels
        assert dataset_fingerprint(back) == dataset_fingerprint(mini)

    def test_title_concatenated(self, tmp_path):
        d = str(tmp_path / "ds")
        os.makedirs(os.path.join(d, "qrels"))
        with open(os.path.join(d, "corpus.jsonl"), "w") as f:
            f.write(json.dumps({"_id": "d1", "title": "A Title", "text": "body"}) + "\n")
        with open(os.path.join(d, "queries.jsonl"), "w") as f:
            f.write(json.dumps({"_id": "q1", "text": "title"}) + "\n")
        with open(os.path.join(d, "qrels", "test.tsv"), "w") as f:
            f.write("query-id\tcorpus-id\tscore\nq1\td1\t1\n")
        ds = load_beir(d)
        assert ds.doc_texts == ["A Title body"]
        assert ds.qrels == {"q1": {"d1": 1}}

    def test_handcrafted_beir_dir_end_to_end(self, tmp_path):
        # A directory laid out by hand (not by our own save) drives
        # load_beir -> build_index -> run_dataset to sane metrics.
        d = tmp_path / "scifact-like"
        (d / "qrels").mkdir(parents=True)
        docs = [
            ("d1", "BM25 scoring", "bm25 ranks documents by term rarity"),
            ("d2", "", "postgres stores relational data"),
            ("d3", "Vector search", "vectors embed documents for ann"),
            ("d4", "", "bm25 uses idf and document length"),
            ("d5", "Databases", "postgres supports full text search"),
            ("d6", "", "unrelated cooking recipe with garlic"),
            ("d7", "", "another unrelated gardening note"),
            ("d8", "Ranking", "learning to rank reorders bm25 output"),
            ("d9", "", "sparse retrieval complements dense vectors"),
            ("d10", "", "term frequency saturates in bm25"),
        ]
        with open(d / "corpus.jsonl", "w") as f:
            for did, title, text in docs:
                f.write(json.dumps({"_id": did, "title": title, "text": text}) + "\n")
        with open(d / "queries.jsonl", "w") as f:
            f.write(json.dumps({"_id": "q1", "text": "bm25 ranking"}) + "\n")
            f.write(json.dumps({"_id": "q2", "text": "postgres text search"}) + "\n")
            f.write(json.dumps({"_id": "q3", "text": "not in qrels"}) + "\n")
        with open(d / "qrels" / "test.tsv", "w") as f:
            f.write("query-id\tcorpus-id\tscore\nq1\td1\t2\nq1\td4\t1\nq2\td5\t1\n")
        ds = load_beir(str(d))
        assert ds.n_docs == 10 and ds.n_queries == 2  # q3 filtered
        index = build_index(ds, engine="stream", device="cpu")
        assert index.device.type == "cpu"
        _, metrics, _ = run_dataset(ds, index, k=10, batch=2)
        assert metrics["ndcg@10"] > 0.5
        assert metrics["recall@10"] == 1.0
        assert oracle_rank_parity(ds, index, k=10) == 0

    def test_queries_filtered_to_qrels_split(self, mini, tmp_path):
        d = str(tmp_path / "ds")
        mini.save(d)
        path = os.path.join(d, "qrels", "test.tsv")
        lines = open(path).read().splitlines()
        open(path, "w").write("\n".join(lines[: 1 + (len(lines) - 1) // 2]) + "\n")
        back = load_beir(d)
        assert back.n_queries < mini.n_queries
        assert all(q in back.qrels for q in back.query_ids)


class TestGenerators:
    def test_mini_fingerprint(self, mini):
        assert dataset_fingerprint(mini) == "01d0543143d5f9a1"
        ref = ref_synthetic.generate_beir_like("scifact-mini", seed=0)
        assert dataset_fingerprint(mini) == ref_synthetic.dataset_fingerprint(ref)
        assert (mini.doc_texts, mini.query_texts, mini.qrels) == (
            ref.doc_texts, ref.query_texts, ref.qrels,
        )

    def test_determinism(self):
        a = generate_beir_like("scifact-mini", seed=0)
        b = generate_beir_like("scifact-mini", seed=0)
        assert dataset_fingerprint(a) == dataset_fingerprint(b)
        c = generate_beir_like("scifact-mini", seed=1)
        assert dataset_fingerprint(c) != dataset_fingerprint(a)
        ref = ref_synthetic.generate_beir_like("scifact-mini", seed=1)
        assert dataset_fingerprint(c) == ref_synthetic.dataset_fingerprint(ref)

    def test_scifact_shape(self):
        ds = generate_beir_like("scifact", seed=0)
        assert ds.n_docs == 5183 and ds.n_queries == 300
        assert dataset_fingerprint(ds) == "472319a39cebf7d9"

    def test_stream_shapes_are_the_references(self):
        assert STREAM_SHAPES == ref_stream_synth.STREAM_SHAPES
        assert STREAM_SHAPES["msmarco-mini"] == (200_000, 512, 40, 65_536, 256)

    @pytest.mark.parametrize("lo,hi", [(0, 300), (8100, 8300), (16384, 16390)])
    def test_stream_source_texts_equal_reference(self, lo, hi):
        src = StreamDocSource("msmarco-mini", seed=0)
        ref = ref_stream_synth.StreamDocSource("msmarco-mini", seed=0)
        got = src(lo, hi)
        assert len(got) == hi - lo and got == ref(lo, hi)
        # Chunking does not change the bytes.
        mid = (lo + hi) // 2
        assert src(lo, mid) + src(mid, hi) == got

    def test_stream_source_is_picklable(self):
        import pickle

        src = StreamDocSource("msmarco-mini", seed=3)
        back = pickle.loads(pickle.dumps(src))
        assert type(back).__module__ == "vectorchord_bm25_tpu_torch.data.stream_synth"
        assert back(10, 20) == src(10, 20)

    def test_generate_streaming_equals_reference(self):
        ds = generate_streaming("msmarco-mini", seed=0)
        ref = ref_stream_synth.generate_streaming("msmarco-mini", seed=0)
        assert ds.n_docs == ref.n_docs == 200_000
        assert ds.n_queries == ref.n_queries == 512
        assert ds.query_ids == ref.query_ids
        assert ds.query_texts == ref.query_texts
        assert ds.qrels == ref.qrels
        assert ds.doc_ids[199_999] == ref.doc_ids[199_999] == "doc199999"


class TestMetrics:
    def test_ndcg_hand_computed(self):
        qrels = {"q": {"a": 2, "b": 1}}
        run = {"q": ["b", "a", "x"]}
        dcg = (2**1 - 1) / np.log2(2) + (2**2 - 1) / np.log2(3)
        idcg = (2**2 - 1) / np.log2(2) + (2**1 - 1) / np.log2(3)
        assert ndcg_at_k(run, qrels, 10) == pytest.approx(dcg / idcg)
        assert ndcg_at_k(run, qrels, 10) == ref_metrics.ndcg_at_k(run, qrels, 10)

    def test_ndcg_perfect_is_one(self):
        assert ndcg_at_k({"q": ["a", "b"]}, {"q": {"a": 3, "b": 1}}, 10) == pytest.approx(1.0)

    def test_ndcg_k_cutoff(self):
        assert ndcg_at_k({"q": ["x", "a"]}, {"q": {"a": 1}}, 1) == 0.0

    def test_recall(self):
        qrels = {"q1": {"a": 1, "b": 1}, "q2": {"c": 1}}
        run = {"q1": ["a", "x"], "q2": ["x", "y"]}
        assert recall_at_k(run, qrels, 2) == pytest.approx(0.25)
        assert recall_at_k(run, qrels, 1) == pytest.approx(0.25)

    def test_unjudged_queries_ignored(self):
        qrels = {"q1": {"a": 1}, "q2": {}}
        run = {"q1": ["a"]}
        assert ndcg_at_k(run, qrels, 10) == pytest.approx(1.0)
        assert recall_at_k(run, qrels, 10) == pytest.approx(1.0)

    def test_evaluate_run_equals_reference(self):
        rng = np.random.default_rng(4)
        qrels = {f"q{i}": {f"d{j}": int(rng.integers(1, 3)) for j in rng.choice(50, 4, replace=False)} for i in range(30)}
        run = {q: [f"d{j}" for j in rng.permutation(50)[: int(rng.integers(0, 50))]] for q in qrels}
        assert evaluate_run(run, qrels) == ref_metrics.evaluate_run(run, qrels)


class TestRunDatasetEqualsReference:
    """The port's run dict and metrics on scifact-mini are the reference's
    (JAX CPU backend), index for index from the same seed."""

    @pytest.mark.parametrize("engine", ["stream", "blockmax", "exact"])
    def test_scifact_mini(self, mini, engine):
        index = build_index(mini, engine=engine, seed=SEED, device="cpu")
        assert isinstance(index, Bm25Index) and index.device.type == "cpu"
        ref = ref_harness.build_index(mini, engine=engine, seed=SEED)
        queries = make_queries(mini, index)
        ref_queries = ref_harness.make_queries(mini, ref)
        assert [q.keys.tolist() for q in queries] == [q.keys.tolist() for q in ref_queries]
        for k, batch in ((100, 64), (10, 32)):
            run, metrics, qps = run_dataset(mini, index, k=k, batch=batch, queries=queries)
            ref_run, ref_metrics_, _ = ref_harness.run_dataset(
                mini, ref, k=k, batch=batch, queries=ref_queries
            )
            assert run == ref_run
            assert metrics == ref_metrics_
            assert qps > 0
        assert oracle_rank_parity(mini, index, k=10, queries=queries) == 0

    def test_streaming_build_equals_in_core(self, mini):
        # build_index_streaming on a dataset whose texts come from a
        # picklable source, through two spawned workers: the reference's
        # run, and the in-core index's.
        ds = _SourcedDataset(mini)
        index = build_index_streaming(ds, seed=SEED, n_workers=2, device="cpu")
        assert index.engine_kind == "stream" and index.device.type == "cpu"
        ref = ref_harness.build_index_streaming(ds, seed=SEED, n_workers=2)
        incore = build_index(mini, seed=SEED, device="cpu")
        run, metrics, _ = run_dataset(mini, index, k=50, batch=64)
        ref_run, ref_m, _ = ref_harness.run_dataset(mini, ref, k=50, batch=64)
        assert (run, metrics) == (ref_run, ref_m)
        assert run == run_dataset(mini, incore, k=50, batch=64)[0]


class _SourcedDataset:
    """scifact-mini with its corpus behind a picklable ``source(lo, hi)``,
    as a StreamingBeirDataset holds it."""

    def __init__(self, ds):
        self.source = TextsSource(ds.doc_texts)
        self.n_docs = ds.n_docs


class TestM2Parity:
    """SURVEY M2: engine ranks == float64 oracle ranks, full query set."""

    @pytest.mark.parametrize("engine", ["hybrid"])
    def test_full_queryset_rank_parity(self, mini, engine):
        index = build_index(mini, engine=engine, device="cpu")
        assert oracle_rank_parity(mini, index, k=10) == 0

    def test_scifact_scale_rank_parity(self):
        # The full frozen SciFact-shaped dataset (5,183 docs, all 300
        # queries), on the served default.
        ds = generate_beir_like("scifact", seed=0)
        index = build_index(ds, engine="stream", device="cpu")
        assert oracle_rank_parity(ds, index, k=10) == 0

    def test_quality_band(self, mini):
        index = build_index(mini, engine="hybrid", device="cpu")
        queries = make_queries(mini, index)
        _, metrics, qps = run_dataset(mini, index, k=600, queries=queries)
        assert 0.55 <= metrics["ndcg@10"] <= 0.99
        assert metrics["recall@1000"] >= metrics["recall@100"] >= metrics["recall@10"]
        assert metrics["recall@1000"] >= 0.9
        assert qps > 0


class TestShardedDataset:
    def test_sharded_metrics_match_single(self, mini):
        single = build_index(mini, engine="exact", seed=SEED, device="cpu")
        sharded = build_index(mini, engine="exact", seed=SEED, shards=8, device="cpu")
        queries = make_queries(mini, single)
        _, m1, _ = run_dataset(mini, single, k=50, batch=16, queries=queries)
        _, m2, _ = run_dataset(mini, sharded, k=50, batch=16, queries=queries)
        for key in m1:
            assert abs(m1[key] - m2[key]) < 1e-9, (key, m1[key], m2[key])
