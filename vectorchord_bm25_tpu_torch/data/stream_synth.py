"""Streamed BEIR-shaped corpus at MS MARCO scale (offline stand-in).

The north-star operating point is MS MARCO passage retrieval (8.84M
passages; the reference's own quality table is BEIR via
`xhluca/bm25-benchmarks`, reference README.md:385-402).  This module
generates a corpus of that scale WITHOUT ever materializing it: documents
are produced deterministically in fixed-aligned blocks, so the
out-of-core builder (`parallel/hostbuild.build_out_of_core`) can stream
text chunks through worker processes, and queries/qrels regenerate their
relevant documents on demand.

Same (shape, seed) => same corpus bytes, independent of chunking: block
b always derives from `default_rng([seed, b])`, and a (lo, hi) request
slices whole blocks.

Words are a pure function of their integer id (consonant-vowel
syllables of the id in base 90), so the multi-hundred-thousand-word
vocabulary costs nothing to "store" and every worker process derives it
identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

__all__ = [
    "StreamingBeirDataset",
    "generate_streaming",
    "STREAM_SHAPES",
]

STREAM_SHAPES = {
    # name: (n_docs, n_queries, avg_len, vocab, n_topics)
    "msmarco": (8_841_823, 4096, 56, 262_144, 4096),
    "msmarco-1m": (1_000_000, 2048, 56, 131_072, 1024),
    "msmarco-mini": (200_000, 512, 40, 65_536, 256),  # CI variant
}

_BLOCK = 8192

_CONS = np.array(list("bcdfghjklmnprstvwz"))
_VOWS = np.array(list("aeiou"))
_SYL = np.array(
    [c + v for c in _CONS for v in _VOWS]
)  # 90 syllables, digit alphabet


def words_for_ids(ids: np.ndarray) -> List[str]:
    """Vectorized id -> unique pronounceable word: the digits of
    (id + 90) in base 90 spell the syllables, so every id gets a
    distinct >=2-syllable word with no stored vocabulary."""
    x = np.asarray(ids, dtype=np.int64) + 90
    out = np.full(x.shape, "", dtype=object)
    while True:
        live = x > 0
        if not live.any():
            break
        digit = x % 90
        out[live] = np.char.add(
            _SYL[digit[live]].astype(object), out[live]
        )
        x = x // 90
    return out.astype(str).tolist()


class _DocIdSeq:
    """Lazy doc-id list: element i is f"doc{i}" (8.8M materialized
    strings would cost ~700 MB)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [f"doc{j}" for j in range(*i.indices(self.n))]
        return f"doc{int(i)}"


class StreamDocSource:
    """Picklable `source(lo, hi) -> list[str]` for build_out_of_core.

    Documents mix corpus-wide Zipf words with a per-doc topic slice of
    the vocabulary (the structure that gives BM25 quality metrics and
    range pruning their realistic behavior), like data/synthetic.py's
    in-memory generator.
    """

    def __init__(self, shape: str, seed: int = 0):
        if shape not in STREAM_SHAPES:
            raise ValueError(
                f"unknown stream shape {shape!r}; one of "
                f"{sorted(STREAM_SHAPES)}"
            )
        self.shape = shape
        self.seed = seed
        (
            self.n_docs,
            self.n_queries,
            self.avg_len,
            self.vocab,
            self.n_topics,
        ) = STREAM_SHAPES[shape]
        self.shared = self.vocab // 4
        self.topic_sz = (self.vocab - self.shared) // self.n_topics

    # -- deterministic block generation ---------------------------------
    def block_word_ids(self, b: int):
        """Word ids for documents of block b: (flat ids, per-doc CSR)."""
        lo = b * _BLOCK
        n = min(_BLOCK, self.n_docs - lo)
        rng = np.random.default_rng([self.seed, b])
        lengths = np.maximum(
            8,
            (self.avg_len * rng.lognormal(0.0, 0.5, size=n)).astype(
                np.int64
            ),
        )
        total = int(lengths.sum())
        doc_of = np.repeat(np.arange(n), lengths)
        topic_of = rng.integers(0, self.n_topics, size=n)
        z = rng.zipf(1.25, size=total)
        topical = rng.random(total) < 0.45
        zt = rng.zipf(1.35, size=total)
        ids = np.where(
            topical,
            self.shared
            + topic_of[doc_of] * self.topic_sz
            + (zt % self.topic_sz),
            z % self.shared,
        )
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=starts[1:])
        return ids, starts

    def doc_word_ids(self, i: int) -> np.ndarray:
        ids, starts = self.block_word_ids(i // _BLOCK)
        j = i % _BLOCK
        return ids[starts[j] : starts[j + 1]]

    def __call__(self, lo: int, hi: int) -> List[str]:
        texts: List[str] = []
        b0, b1 = lo // _BLOCK, (hi - 1) // _BLOCK
        for b in range(b0, b1 + 1):
            ids, starts = self.block_word_ids(b)
            j0 = max(lo - b * _BLOCK, 0)
            j1 = min(hi - b * _BLOCK, starts.size - 1)
            words = np.asarray(
                words_for_ids(ids[starts[j0] : starts[j1]]), dtype=object
            )
            rel = starts[j0 : j1 + 1] - starts[j0]
            texts.extend(
                " ".join(words[rel[j] : rel[j + 1]])
                for j in range(j1 - j0)
            )
        return texts


@dataclass
class StreamingBeirDataset:
    """BEIR-protocol dataset whose corpus streams from a deterministic
    source instead of living in memory (duck-compatible with
    data/harness.run_dataset: doc_ids indexes lazily)."""

    name: str
    source: StreamDocSource
    query_ids: List[str]
    query_texts: List[str]
    qrels: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return self.source.n_docs

    @property
    def n_queries(self) -> int:
        return len(self.query_ids)

    @property
    def doc_ids(self):
        return _DocIdSeq(self.source.n_docs)


def generate_streaming(
    shape: str = "msmarco", seed: int = 0
) -> StreamingBeirDataset:
    """Queries + qrels for the streamed corpus (the corpus itself stays
    a generator).  Primaries are sampled in a small number of blocks so
    query generation regenerates only those blocks."""
    src = StreamDocSource(shape, seed)
    rng = np.random.default_rng([seed, 1 << 40])
    n_blocks = (src.n_docs + _BLOCK - 1) // _BLOCK
    nq = src.n_queries
    # ~64 primaries per sampled block.
    n_qblocks = max(1, nq // 64)
    qblocks = rng.choice(n_blocks, size=n_qblocks, replace=False)
    query_texts: List[str] = []
    qrels: Dict[str, Dict[str, int]] = {}
    qi = 0
    for b in qblocks:
        ids, starts = src.block_word_ids(int(b))
        n_in_block = starts.size - 1
        take = min(64, nq - qi, n_in_block)
        picks = rng.choice(n_in_block, size=take, replace=False)
        for j in picks:
            w = ids[starts[j] : starts[j + 1]]
            topical = w[w >= src.shared]
            pool = topical if topical.size >= 2 else w
            n_terms = int(rng.integers(2, 6))
            terms = rng.choice(
                np.unique(pool),
                size=min(n_terms, np.unique(pool).size),
                replace=False,
            ).tolist()
            # 0-2 common-word distractors (realistic imperfect queries;
            # also populates the router's heavy group).
            for _ in range(int(rng.integers(0, 3))):
                terms.append(int(rng.zipf(1.25)) % src.shared)
            rng.shuffle(terms)
            query_texts.append(" ".join(words_for_ids(np.asarray(terms))))
            qrels[f"q{qi}"] = {f"doc{int(b) * _BLOCK + int(j)}": 1}
            qi += 1
        if qi >= nq:
            break
    return StreamingBeirDataset(
        name=f"synthetic-{shape}",
        source=src,
        query_ids=[f"q{i}" for i in range(qi)],
        query_texts=query_texts,
        qrels=qrels,
    )
