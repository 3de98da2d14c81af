"""The Block-Max engine served through the facade (``Bm25Index(engine=
"blockmax")``, ``search_batch_async`` and ``finalize()``) on a seeded
corpus of the benchmark's own model, held to the benchmark's plain float64
reference with the benchmark's limits: no rank error, no missing result,
every score within 1e-4 of the reference's."""

import copy
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from portbench.check import compare  # noqa: E402
from portbench.corpus import CorpusModel, col_of, generator, make_corpus, make_postings, payload_of  # noqa: E402
from portbench.queries import make_queries  # noqa: E402
from portbench.reference.bm25 import Reference, gather, top_lists  # noqa: E402
from portbench.tests.tiny import tiny_cell  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import build_sealed_segment_from_postings  # noqa: E402
from vectorchord_bm25_tpu_torch.text.intern import Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.options import IndexOptions  # noqa: E402

torch.set_num_threads(2)

CELL = "msmarco-blockmax.top100"
SEED = 2**31 + 1234
BATCH, BATCHES = 48, 2
LIMITS = {"score_rel_err": 1e-4, "rank_errors": 0, "missing_results": 0}


@pytest.fixture(scope="module")
def data():
    """The cell's corpus model at 4,000 docs (``tiny_cell``'s cut), its
    queries and 60 documents to insert."""
    cfg = tiny_cell(CELL).config
    model = CorpusModel.from_config(cfg)
    corpus = make_corpus(model, SEED, "cpu")
    q_start, q_tid = make_queries(corpus, BATCH * BATCHES, {"model": "topic", "mix": "heavy", "terms": 4}, SEED, "cpu")
    ex = make_postings(model, 60, generator(SEED, "inserts", "cpu"), "cpu")
    extra = (ex.start.cpu().numpy(), ex.tid.cpu().numpy(), ex.tf.cpu().numpy())
    return model, corpus, q_start, q_tid, extra


def _index(model, corpus, engine_options):
    n = model.n_docs
    options = IndexOptions(k1=1.2, b=0.75)
    sealed = build_sealed_segment_from_postings(
        None, corpus.doc.copy(), corpus.tf.copy(), n,
        payloads=payload_of(np.arange(n)), options=options, presorted=True,
        token_ids=corpus.tid.copy(), vocab_keys=harness.word_keys(model.vocab),
    )
    return Bm25Index(
        sealed, hashlib.sha256(b"served").digest(), options,
        engine="blockmax", engine_options=engine_options, device="cpu",
    )


def _serve_and_compare(index, model, corpus, q_start, q_tid, k, extra=None, visible=0, deleted=()):
    """Every batch through ``search_batch_async`` with the next one in
    flight, then the readings of ``check.compare`` against the float64
    reference; returns (readings, rounds of each batch)."""
    keys = harness.word_keys(model.vocab)
    words = [q_tid[q_start[i] : q_start[i + 1]] for i in range(BATCH * BATCHES)]
    pending, got, rounds = [], [], []
    for b in range(BATCHES):
        queries = [Query(keys=keys[w]) for w in words[b * BATCH : (b + 1) * BATCH]]
        pending.append(index.search_batch_async(queries, k))
        rounds.append(index.engine().last_rounds)
        if len(pending) == 2:
            got += pending.pop(0)()
    for fin in pending:
        got += fin()
    lists = [
        list(zip([h.score for h in hits], col_of(np.array([h.payload for h in hits], dtype=np.int64)).tolist()))
        for hits in got
    ]
    ref = Reference(
        corpus.tid, corpus.doc, corpus.tf, model.n_docs, model.vocab, 1.2, 0.75, "cpu",
        inserted=extra,
    )
    n_q = len(words)
    acc = ref.sums(
        words,
        [visible] * n_q if extra is not None else None,
        [np.asarray(deleted, dtype=np.int64)] * n_q,
    )
    want = top_lists(acc, k)
    wog = gather(acc, [np.asarray([c for _, c in g], dtype=np.int64) for g in lists])
    return compare(lists, want, wog, LIMITS["score_rel_err"]), rounds


def _correct(readings):
    values = dict(readings.values())
    return all(values[name] <= LIMITS[name] for name in LIMITS) and readings.queries == BATCH * BATCHES


@pytest.mark.parametrize("chunk", [2, None], ids=["chunk2", "chunk_default"])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("posting_mode", ["tf", "impact"])
def test_facade_matches_reference(data, posting_mode, k, chunk):
    model, corpus, q_start, q_tid, _ = data
    opts = {"posting_mode": posting_mode}
    if chunk is not None:
        opts["chunk"] = chunk
    index = _index(model, corpus, opts)
    readings, rounds = _serve_and_compare(index, model, corpus, q_start, q_tid, k)
    assert _correct(readings), (readings.values(), readings.worst)
    if chunk == 2:
        assert min(rounds) > 1  # several pruning rounds a batch
    else:
        assert min(rounds) >= 1


@pytest.mark.parametrize("posting_mode", ["tf", "impact"])
def test_facade_with_inserts_and_deletes_matches_reference(data, posting_mode):
    model, corpus, q_start, q_tid, extra = data
    index = _index(model, corpus, {"posting_mode": posting_mode, "chunk": 4})
    keys = harness.word_keys(model.vocab)
    start, tid, tf = extra
    n, e = model.n_docs, start.size - 1
    for j in range(e):
        index.insert(Document(keys=keys[tid[start[j] : start[j + 1]]], values=tf[start[j] : start[j + 1]]), int(payload_of(n + j)))
    # Sealed and inserted documents alike, some of them in the results.
    deleted = np.array([0, 5, 17, 255, 256, 1999, n + 1, n + 30], dtype=np.int64)
    index.bulkdelete_payloads(payload_of(deleted))
    readings, rounds = _serve_and_compare(
        index, model, corpus, q_start, q_tid, 100, extra=extra, visible=e, deleted=deleted
    )
    assert _correct(readings), (readings.values(), readings.worst)
    assert min(rounds) > 1


def test_tiny_cell_run_is_correct():
    """The benchmark's own run of the cell at a CPU size, several rounds a
    batch, traced: correct, and the engine's readers find their spans."""
    cell = tiny_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["index"]["engine_options"]["chunk"] = 4
    # The engine's readers, which no accepted metric lists for the cell yet.
    cell.per_layer = cell.per_layer + [
        {"name": name, "unit": "-"} for name in ("bm_rounds", "bm_loop_ms", "bm_flag_ms", "blockmax_roofline")
    ]
    # The profiled steps start at 40% of the window, after the step that
    # crosses it: a window of several CPU steps keeps them inside it.
    result, _ = harness.run_cell(cell, 2**31 + 77, 4.0, True, "cpu", 0.0)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["bm_rounds"]["value"] > 1
    assert m["bm_loop_ms"]["value"] > 0 and m["bm_flag_ms"]["value"] > 0
    assert "blockmax_roofline" not in m  # no device trace on the CPU
    kernels = result["run"]["kernels"]
    assert kernels["p1_tf"]["calls"] == kernels["b1_merge"]["calls"] > 0
    assert kernels["b1_select"]["calls"] == kernels["p1_tf"]["calls"] + kernels["b1_bounds"]["calls"]
    assert all(kernels[name]["bound_s"] > 0 for name in ("p1_tf", "b1_bounds", "b1_select", "b1_merge"))
