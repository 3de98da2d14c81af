"""Deterministic BEIR-shaped dataset generator (offline stand-in).

The bench environment has no network egress, so real BEIR datasets
(SciFact, trec-covid) cannot be fetched there.  Per the project's
baseline protocol, this module deterministically generates a frozen
dataset with the same *shape and layout* as the real thing, so the whole
quality harness (tokenizer -> index -> retrieval -> NDCG/recall) runs
end-to-end and reproducibly:

- `scifact`-like: 5,183 docs / 300 test queries / ~1.1 binary qrels per
  query, ~180-word abstracts (the real SciFact's shape);
- generated text is English-like (seeded syllable words, Zipf unigram
  distribution, topic clusters), emitted through the real tokenizer;
- queries sample informative terms from their relevant document plus
  distractor terms, so BM25 quality metrics are non-trivial (NDCG < 1).

Replacing it with the real dataset: download the BEIR zip (e.g.
https://public.ukp.informatik.tu-darmstadt.de/thakur/BEIR/datasets/scifact.zip),
unpack, and pass the directory to `bench.py --dataset <dir>` /
`load_beir(<dir>)` — the generator writes the identical layout, nothing
else in the harness changes.

Everything derives from one seeded numpy Generator (PCG64 is
bit-stable across numpy versions), so the dataset is a frozen artifact:
tests pin a content hash to catch accidental drift.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from .beir import BeirDataset

__all__ = ["generate_beir_like", "dataset_fingerprint"]

_SHAPES = {
    # name: (n_docs, n_queries, avg_len, vocab, n_topics)
    "scifact": (5183, 300, 180, 18000, 120),
    "scifact-mini": (600, 60, 120, 6000, 30),  # fast CI variant
}

_CONSONANTS = list("bcdfghjklmnprstvwz")
_VOWELS = list("aeiou")


def _make_vocab(rng: np.random.Generator, size: int) -> List[str]:
    """Unique pronounceable lowercase words, 2-5 syllables."""
    words: List[str] = []
    seen = set()
    while len(words) < size:
        need = size - len(words)
        n_syll = rng.integers(2, 6, size=need)
        for ns in n_syll:
            w = "".join(
                _CONSONANTS[rng.integers(0, len(_CONSONANTS))]
                + _VOWELS[rng.integers(0, len(_VOWELS))]
                for _ in range(int(ns))
            )
            if w not in seen:
                seen.add(w)
                words.append(w)
    return words


def generate_beir_like(
    shape: str = "scifact", seed: int = 0, name: Optional[str] = None
) -> BeirDataset:
    """Generate the frozen dataset; same (shape, seed) => same bytes."""
    if shape not in _SHAPES:
        raise ValueError(f"unknown shape {shape!r}; one of {sorted(_SHAPES)}")
    n_docs, n_queries, avg_len, vocab_size, n_topics = _SHAPES[shape]
    rng = np.random.default_rng(seed)
    vocab = np.asarray(_make_vocab(rng, vocab_size), dtype=object)

    shared = vocab_size // 4  # word ids [0, shared) are corpus-wide
    topic_sz = (vocab_size - shared) // n_topics

    lengths = np.maximum(
        30, (avg_len * rng.lognormal(0.0, 0.45, size=n_docs)).astype(np.int64)
    )
    topic_of = rng.integers(0, n_topics, size=n_docs)
    doc_texts: List[str] = []
    doc_word_ids: List[np.ndarray] = []
    for i in range(n_docs):
        n = int(lengths[i])
        n_topical = int(n * 0.45)
        common = rng.zipf(1.25, size=n - n_topical) % shared
        topical = (
            shared
            + int(topic_of[i]) * topic_sz
            + (rng.zipf(1.35, size=n_topical) % topic_sz)
        )
        ids = np.concatenate([common, topical])
        rng.shuffle(ids)
        doc_word_ids.append(ids)
        doc_texts.append(" ".join(vocab[ids]))

    # Queries: informative terms from one relevant doc + distractors.
    # df over word ids for idf-weighting.
    df = np.zeros(vocab_size, dtype=np.int64)
    for ids in doc_word_ids:
        df[np.unique(ids)] += 1
    query_texts: List[str] = []
    qrels = {}
    doc_ids = [f"doc{i}" for i in range(n_docs)]
    for qi in range(n_queries):
        primary = int(rng.integers(0, n_docs))
        ids = np.unique(doc_word_ids[primary])
        w = np.log((n_docs + 1.0) / (df[ids] + 0.5))
        w = np.maximum(w, 1e-9)
        w /= w.sum()
        n_terms = int(rng.integers(2, 6))
        picks = rng.choice(ids.size, size=min(n_terms, ids.size), replace=False, p=w)
        terms = list(vocab[ids[picks]])
        # 1-3 distractor terms from the corpus-wide pool (may not occur in
        # the relevant doc), making retrieval imperfect.
        for _ in range(int(rng.integers(1, 4))):
            terms.append(str(vocab[int(rng.zipf(1.25)) % shared]))
        rng.shuffle(terms)
        query_texts.append(" ".join(terms))
        rels = {doc_ids[primary]: 1}
        # ~15% of queries have a second relevant doc from the same topic.
        if rng.random() < 0.15:
            same_topic = np.flatnonzero(topic_of == topic_of[primary])
            other = int(same_topic[rng.integers(0, same_topic.size)])
            rels[doc_ids[other]] = 1
        qrels[f"q{qi}"] = rels

    return BeirDataset(
        name=name or f"synthetic-{shape}",
        doc_ids=doc_ids,
        doc_texts=doc_texts,
        query_ids=[f"q{i}" for i in range(n_queries)],
        query_texts=query_texts,
        qrels=qrels,
    )


def dataset_fingerprint(ds: BeirDataset) -> str:
    """Content hash pinning the frozen dataset against drift."""
    h = hashlib.sha256()
    for part in (ds.doc_ids, ds.doc_texts, ds.query_ids, ds.query_texts):
        for s in part:
            h.update(s.encode())
            h.update(b"\x00")
    for qid in ds.query_ids:
        for did, rel in sorted(ds.qrels.get(qid, {}).items()):
            h.update(f"{qid}|{did}|{rel}".encode())
    return h.hexdigest()[:16]
