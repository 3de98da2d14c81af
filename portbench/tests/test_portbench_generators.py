"""The benchmark's generators: deterministic per seed, and the model of
the repo's numpy generators at a small size."""

import numpy as np
import pytest
import torch

from portbench.corpus import CorpusModel, col_of, make_corpus, payload_of, zipf, generator
from portbench.queries import make_queries

SEED = 2**33 + 5


def synth_model(n_docs=4000, vocab=5000, topics=16):
    return CorpusModel(
        n_docs=n_docs, mean_len=80.0, len_sigma=0.6, min_len=4, vocab=vocab, n_topics=topics,
        shared_vocab=vocab // 5, shared_token_share=0.4, zipf_shared=1.3, zipf_topic=1.3,
        topics_sorted=True,
    )


def stream_model(n_docs=8192, vocab=16384, topics=64):
    return CorpusModel(
        n_docs=n_docs, mean_len=40.0, len_sigma=0.5, min_len=8, vocab=vocab, n_topics=topics,
        shared_vocab=vocab // 4, shared_token_share=0.55, zipf_shared=1.25, zipf_topic=1.35,
        topics_sorted=False,
    )


def test_zipf_matches_numpy():
    got = zipf(1.3, 400_000, generator(SEED, "z", "cpu"), "cpu").numpy()
    want = np.random.default_rng(3).zipf(1.3, 400_000)
    for v in (1, 2, 3, 10):
        assert abs((got == v).mean() - (want == v).mean()) < 0.005
    assert got.min() >= 1


def test_corpus_is_deterministic_per_seed():
    a = make_corpus(synth_model(), SEED, "cpu")
    b = make_corpus(synth_model(), SEED, "cpu")
    c = make_corpus(synth_model(), SEED + 1, "cpu")
    assert np.array_equal(a.tid, b.tid) and np.array_equal(a.doc, b.doc) and np.array_equal(a.tf, b.tf)
    assert not (a.tid.size == c.tid.size and np.array_equal(a.tid, c.tid))
    order = np.lexsort((a.doc, a.tid))
    assert np.array_equal(order, np.arange(a.tid.size))  # sorted by (word, doc)


def test_synth_model_matches_numpy_copy():
    from vectorchord_bm25_tpu_torch.data.synth import synth_corpus_postings

    m = synth_model()
    got = make_corpus(m, SEED, "cpu")
    keys, docs, tfs, _ = synth_corpus_postings(m.n_docs, m.vocab, m.len_scale, seed=4, n_topics=m.n_topics)
    got_len = got.tf.sum() / m.n_docs
    want_len = tfs.sum() / m.n_docs
    assert abs(got_len - want_len) / want_len < 0.03
    assert abs(got.tf.sum() / m.n_docs - m.mean_len) / m.mean_len < 0.03
    ids = keys.view(np.uint8).reshape(-1, 16)[:, :4].copy().view(">u4").ravel()
    want_df = np.bincount(ids, minlength=m.vocab)
    got_df = np.bincount(got.tid, minlength=m.vocab)
    for w in (1, 2, 3):  # the Zipf head of the shared words (Zipf draws start at 1)
        assert abs(got_df[w] - want_df[w]) / want_df[w] < 0.05
    assert abs(got.tid.size - ids.size) / ids.size < 0.03


def test_stream_model_matches_numpy_copy():
    from vectorchord_bm25_tpu_torch.data.stream_synth import StreamDocSource

    m = stream_model()
    src = StreamDocSource("msmarco-mini", seed=4)
    src.n_docs, src.avg_len, src.vocab, src.n_topics = m.n_docs, m.len_scale, m.vocab, m.n_topics
    src.shared = m.shared_vocab
    src.topic_sz = (m.vocab - m.shared_vocab) // m.n_topics
    ids, starts = src.block_word_ids(0)
    got = make_corpus(m, SEED, "cpu")
    assert abs(got.tf.sum() / m.n_docs - (starts[-1] / (starts.size - 1))) / m.mean_len < 0.03
    want_df = np.zeros(m.vocab, dtype=np.int64)
    doc = np.repeat(np.arange(starts.size - 1), np.diff(starts))
    uniq = np.unique(doc * m.vocab + ids)
    np.add.at(want_df, uniq % m.vocab, 1)
    got_df = np.bincount(got.tid, minlength=m.vocab)
    for w in (1, 2, 3):
        assert abs(got_df[w] - want_df[w]) / want_df[w] < 0.05
    assert abs(got.tid.size - uniq.size) / uniq.size < 0.03


@pytest.mark.parametrize(
    "spec", [{"model": "doc_sampled", "terms": 6}, {"model": "topic", "mix": "heavy", "terms": 4},
             {"model": "topic", "mix": "informative", "terms": 4}],
    ids=["doc_sampled", "heavy", "informative"],
)
def test_queries_deterministic_and_shaped(spec):
    m = stream_model(n_docs=4096, vocab=8192, topics=32)
    corpus = make_corpus(m, SEED, "cpu")
    s1, t1 = make_queries(corpus, 500, spec, SEED, "cpu")
    s2, t2 = make_queries(make_corpus(m, SEED, "cpu"), 500, spec, SEED, "cpu")
    assert np.array_equal(s1, s2) and np.array_equal(t1, t2)
    sizes = np.diff(s1)
    assert sizes.min() >= 1 and sizes.max() <= spec["terms"]
    df = np.bincount(corpus.tid, minlength=m.vocab)
    assert (df[t1] > 0).all()
    for q in range(0, 500, 37):
        words = t1[s1[q] : s1[q + 1]]
        assert np.all(np.diff(words) > 0)
    if spec["model"] == "topic":
        shared = np.array([np.sum(t1[s1[q] : s1[q + 1]] < m.shared_vocab) for q in range(500)])
        if spec["mix"] == "heavy":
            assert shared.min() >= 1 and shared.max() <= 2 and 0.35 < (shared == 2).mean() < 0.65
        else:
            assert shared.max() <= 1 and 0.35 < (shared == 1).mean() < 0.65


def test_doc_sampled_queries_come_from_one_doc():
    m = synth_model(n_docs=2000)
    corpus = make_corpus(m, SEED, "cpu")
    start, words = make_queries(corpus, 200, {"model": "doc_sampled", "terms": 6}, SEED, "cpu")
    by_doc = {}
    for t, d in zip(corpus.tid.tolist(), corpus.doc.tolist()):
        by_doc.setdefault(d, set()).add(t)
    for q in range(200):
        ws = set(words[start[q] : start[q + 1]].tolist())
        assert any(ws <= s for s in by_doc.values())


def test_payloads_round_trip():
    cols = np.array([0, 1, 2, 3, 4, 171_331, 2_097_151, 10_000_000])
    p = payload_of(cols)
    assert np.array_equal(col_of(p), cols)
    assert not np.array_equal(np.argsort(p), np.argsort(cols))
    assert col_of(np.array([-5]))[0] == -1
