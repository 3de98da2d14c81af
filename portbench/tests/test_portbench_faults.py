"""A run whose timed path is broken underneath comes out not correct:
the harness without its look for a card, at a CPU size, with one fault
planted in the program's entry."""

import numpy as np
import pytest

from vectorchord_bm25_tpu_torch.index.bm25index import Bm25Index, SearchHit

from .tiny import run_tiny

_dispatch = Bm25Index._search_batch_dispatch


def _broken_finalize(change):
    def dispatch(self, queries, k, filter_fn=None):
        fin = _dispatch(self, queries, k, filter_fn)
        return lambda: change(fin())

    return dispatch


def _alter_one_answer(lists):
    """The best hit of every query gets another document's payload."""
    out = []
    for hits in lists:
        if hits:
            hits = [SearchHit(hits[0].score, hits[0].payload ^ 1)] + hits[1:]
        out.append(hits)
    return out


def _scale_scores(lists):
    return [[SearchHit(h.score * (1 + 1e-3), h.payload) for h in hits] for hits in lists]


def _half_left_out(lists):
    half = len(lists) // 2
    return lists[:half] + [[] for _ in lists[half:]]


def _half_dropped(lists):
    return lists[: len(lists) // 2]


@pytest.mark.parametrize(
    "name", ["trec-covid.search", "msmarco.heavy"],
)
@pytest.mark.parametrize(
    "fault", [_alter_one_answer, _scale_scores, _half_left_out, _half_dropped],
    ids=["answer_altered", "scores_altered", "half_batch_empty", "half_batch_dropped"],
)
def test_faults_come_out_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(Bm25Index, "_search_batch_dispatch", _broken_finalize(fault))
    result, lines = run_tiny(name)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0 and lines


def test_inserts_left_undone_come_out_not_correct(monkeypatch):
    """A write step that leaves the index's state unchanged."""
    calls = {"n": 0}
    real = Bm25Index.insert

    def insert(self, document, payload):
        calls["n"] += 1
        if calls["n"] > 200:  # the preload goes in, the window's inserts do not
            return None
        return real(self, document, payload)

    monkeypatch.setattr(Bm25Index, "insert", insert)
    result, _ = run_tiny("trec-covid.ingest", seconds=2.0, check_queries=256, writes={"inserts_per_step": 300})
    assert not result["correct"], result["checks"]


def test_deletes_left_undone_come_out_not_correct(monkeypatch):
    monkeypatch.setattr(Bm25Index, "bulkdelete_payloads", lambda self, payloads: 0)
    result, _ = run_tiny("trec-covid.ingest", seconds=1.0, check_queries=256, writes={"deletes_per_step": 20})
    assert not result["correct"], result["checks"]


def test_a_sound_run_is_correct():
    result, lines = run_tiny("trec-covid.ingest")
    assert result["correct"] and result["failed"] == 0 and not lines
