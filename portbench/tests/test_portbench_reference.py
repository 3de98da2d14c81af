"""The plain reference against BM25 worked by hand on a toy corpus, and
against the port's CPU path through a whole run."""

import math

import numpy as np
import pytest
import torch

from portbench.check import compare
from portbench.reference.bm25 import FIELDNORM_TO_LENGTH, Reference, fieldnorm, gather, top_lists

from .tiny import WORKLOADS, run_tiny

# Three docs over words 0..3 (doc: {word: tf}); postings sorted by word.
DOCS = {0: {0: 2, 1: 1}, 1: {0: 1, 2: 3}, 2: {1: 1, 3: 1, 0: 1}}


def _postings():
    rows = sorted((w, d, tf) for d, ws in DOCS.items() for w, tf in ws.items())
    return (np.array([r[i] for r in rows], dtype=np.int64) for i in range(3))


def _by_hand(words, k1=1.2, b=0.75):
    n = len(DOCS)
    lengths = {d: sum(ws.values()) for d, ws in DOCS.items()}
    avgdl = sum(lengths.values()) / n
    out = {}
    for d, ws in DOCS.items():
        s = 0.0
        for w in words:
            if w in ws:
                df = sum(w in x for x in DOCS.values())
                idf = math.log((n + 1) / (df + 0.5))
                tf = ws[w]
                s += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * lengths[d] / avgdl))
        out[d] = s
    return out


def test_fieldnorm_table_is_the_ports():
    from vectorchord_bm25_tpu_torch.models.fieldnorm import FIELDNORM_TO_LENGTH as port_table

    assert np.array_equal(FIELDNORM_TO_LENGTH, port_table)
    lengths = torch.tensor([0, 5, 39, 40, 41, 47, 100, 10_000, 4_000_000])
    got = FIELDNORM_TO_LENGTH[fieldnorm(lengths).numpy()]
    assert np.all(got <= lengths.numpy())


def test_toy_corpus_by_hand():
    tid, doc, tf = _postings()
    ref = Reference(tid, doc, tf, 3, 4, 1.2, 0.75, "cpu")
    acc = ref.sums([np.array([0, 1]), np.array([2]), np.array([3, 0]), np.array([9 % 4])])
    for row, words in enumerate(([0, 1], [2], [3, 0])):
        want = _by_hand(words)
        for d in range(3):
            assert acc[row, d].item() == pytest.approx(want[d], rel=1e-12)
    lists = top_lists(acc, 2)
    s, c = lists[0]
    want = _by_hand([0, 1])
    order = sorted(want, key=lambda d: (-want[d], d))[:2]
    assert c.tolist() == order
    assert lists[1][1].tolist() == [1]  # only doc 1 has word 2; score > 0 only


def test_ties_break_by_column():
    tid = np.array([0, 0, 0], dtype=np.int64)
    doc = np.array([0, 1, 2], dtype=np.int64)
    tf = np.array([1, 1, 1], dtype=np.int64)
    ref = Reference(tid, doc, tf, 3, 1, 1.2, 0.75, "cpu")
    acc = ref.sums([np.array([0])])
    assert top_lists(acc, 2)[0][1].tolist() == [0, 1]


def test_inserted_and_deleted_docs():
    tid, doc, tf = _postings()
    inserted = (np.array([0, 2, 3]), np.array([0, 7, 1]), np.array([5, 1, 1]))
    ref = Reference(tid, doc, tf, 3, 8, 1.2, 0.75, "cpu", inserted=inserted)
    acc = ref.sums([np.array([0, 7]), np.array([0]), np.array([1])], visible=[2, 1, 0], deleted=[[], [3], [0]])
    assert acc[0, 3] > 0  # inserted doc 0 matches word 0; word 7 is unknown to the sealed docs
    assert acc[0, 4] == 0
    assert acc[1, 3] == 0  # deleted before query 1
    assert acc[2, 0] == 0 and acc[2, 4] == 0  # deleted, and not yet inserted


def test_compare_counts_faults():
    want = (np.array([3.0, 2.0, 1.0]), np.array([5, 6, 7]))
    exact = [(3.0, 5), (2.0, 6), (1.0, 7)]
    r = compare([exact], [want], [np.array([3.0, 2.0, 1.0])], 1e-5)
    assert r.rank_errors == 0 and r.score_rel_err == 0.0
    swapped = [(3.0, 5), (1.0, 7), (2.0, 6)]
    r = compare([swapped], [want], [np.array([3.0, 1.0, 2.0])], 1e-5)
    assert r.rank_errors >= 2
    short = [(3.0, 5), (2.0, 6)]
    assert compare([short], [want], [np.array([3.0, 2.0])], 1e-5).rank_errors == 1
    off = [(3.0001, 5), (2.0, 6), (1.0, 7)]
    assert compare([off], [want], [np.array([3.0, 2.0, 1.0])], 1e-5).score_rel_err > 1e-5
    assert compare([None], [want], [np.zeros(0)], 1e-5).rank_errors == 3
    tied = (np.array([2.0, 2.0]), np.array([5, 6]))
    assert compare([[(2.0, 6), (2.0, 5)]], [tied], [np.array([2.0, 2.0])], 1e-5).rank_errors == 1


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_ports_cpu_path_agrees(name):
    result, _ = run_tiny(name)
    checks = result["checks"]
    assert result["correct"], checks
    assert checks["rank_errors"]["value"] == 0 and checks["missing_results"]["value"] == 0
    assert checks["score_rel_err"]["value"] < 1e-6
    assert result["run"]["sampled_queries"] > 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_the_sparse_path_agrees(monkeypatch):
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    monkeypatch.setattr(StreamEngine, "SPARSE_MIN_DOCS", 1024)
    monkeypatch.setattr(StreamEngine, "MS_ROUTE_MIN_WINDOWS", 1)
    result, _ = run_tiny("msmarco.heavy")
    assert result["correct"], result["checks"]
