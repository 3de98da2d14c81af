"""BM25 scoring math.

The scoring model mirrors the reference formulas exactly
(reference: crates/bm25/src/bm25.rs:285-359):

    idf(N, df)            = ln((N + 1) / (df + 0.5))
    tf(fn, tf, k1, b, dl) = tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
    score                 = idf * tf

where `dl = fieldnorm_to_length(fieldnorm)` uses the quantized document
length.  Like the reference's `Cache` (bm25.rs:334-359) we precompute, per
query term, `s0 = idf * (k1 + 1)` and a shared 256-entry table
`s1[fn] = k1 * (1 - b + b * fieldnorm_to_length(fn) / avgdl)` so each
posting scores as one fused multiply/divide on the VPU:

    score(posting) = tf * s0[term] / (tf + s1[fieldnorm[doc]])

Host math is float64 (matching the reference); device tables are exported
as float32 for TPU execution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .fieldnorm import FIELDNORM_TO_LENGTH

__all__ = ["idf", "tf", "bm25_score", "ScoreTables", "max_impact"]


def idf(number_of_documents, token_number_of_documents):
    """Inverse document frequency; reference crates/bm25/src/bm25.rs:285-289."""
    n = np.asarray(number_of_documents, dtype=np.float64)
    df = np.asarray(token_number_of_documents, dtype=np.float64)
    return np.log((n + 1.0) / (df + 0.5))


def tf(fieldnorm, term_frequency, k1, b, avgdl):
    """Term-frequency saturation; reference crates/bm25/src/bm25.rs:291-295."""
    t = np.asarray(term_frequency, dtype=np.float64)
    dl = FIELDNORM_TO_LENGTH[np.asarray(fieldnorm, dtype=np.int64)].astype(np.float64)
    return (t * (k1 + 1.0)) / (t + k1 * (1.0 - b + b * dl / avgdl))


def bm25_score(n_docs, df, fieldnorm, term_frequency, k1, b, avgdl):
    """Full per-(term, posting) BM25 contribution: idf * tf."""
    return idf(n_docs, df) * tf(fieldnorm, term_frequency, k1, b, avgdl)


@dataclass(frozen=True)
class ScoreTables:
    """Precomputed scoring tables for one sealed segment (the `Cache` analog).

    s1_table: [256] float64 — k1 * (1 - b + b * len(fn) / avgdl), shared by
        every term of the segment (reference bm25.rs:349-353).
    """

    k1: float
    b: float
    avgdl: float
    n_docs: int
    s1_table: np.ndarray

    @classmethod
    def create(cls, k1: float, b: float, n_docs: int, sum_dl: int) -> "ScoreTables":
        avgdl = float(sum_dl) / float(n_docs) if n_docs > 0 else 1.0
        lengths = FIELDNORM_TO_LENGTH.astype(np.float64)
        s1 = k1 * (1.0 - b + b * lengths / avgdl)
        return cls(k1=k1, b=b, avgdl=avgdl, n_docs=n_docs, s1_table=s1)

    def s0(self, df) -> np.ndarray:
        """Per-term s0 = idf * (k1 + 1); reference bm25.rs:348."""
        return idf(self.n_docs, df) * (self.k1 + 1.0)

    def evaluate(self, s0, fieldnorm, term_frequency) -> np.ndarray:
        """score = tf * s0 / (tf + s1[fieldnorm]); reference bm25.rs:355-358."""
        t = np.asarray(term_frequency, dtype=np.float64)
        s1 = self.s1_table[np.asarray(fieldnorm, dtype=np.int64)]
        return (t * np.asarray(s0, dtype=np.float64)) / (t + s1)


def max_impact(fieldnorms, term_frequencies, k1, b, avgdl):
    """Return (fieldnorm, term_frequency) of the posting with maximal tf-score.

    The reference's `Wand` tracker (bm25.rs:297-332) keeps the posting whose
    *tf component* (not the full score; idf is constant within a term) is
    maximal; ties keep the first encountered (strict `<` update).  This is the
    per-token / per-block "max impact" metadata used for WAND upper bounds.

    Vectorized: given parallel arrays of fieldnorms and term frequencies,
    returns the pair from the first index attaining the maximum tf value.
    """
    fns = np.asarray(fieldnorms, dtype=np.int64)
    tfs = np.asarray(term_frequencies, dtype=np.int64)
    if fns.size == 0:
        return np.uint8(255), np.uint32(0)
    scores = tf(fns, tfs, k1, b, avgdl)
    i = int(np.argmax(scores))  # argmax returns first maximal index
    return np.uint8(fns[i]), np.uint32(tfs[i])
