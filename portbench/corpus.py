"""The corpus, made on the device from ``--seed``.

One general generator for every configuration: a configuration's
``corpus_model`` names its parameters (vocabulary, topics, the shared
share of the vocabulary and of the tokens, two Zipf exponents, the
log-normal length spread, the least length, and whether topics come in
doc order).  It is the model of the repo's two numpy generators,
``bench.py``'s ``synth_corpus_postings`` (topics sorted by doc, one Zipf
exponent) and ``data/stream_synth.py``'s MS MARCO-shaped doc model (topics
at random, one exponent each for the shared and the topical words), in a
few large torch calls on the card; it is not bit-equal to them.

A document's length is ``max(min_len, floor(scale * exp(sigma * z)))``
with ``scale = mean_len / exp(sigma^2 / 2)``, so the mean length is the
source's (the numpy copies take ``scale`` as their ``avg_len``).  Each
token is a shared word with probability ``shared_token_share``, drawn
``Zipf(zipf_shared) mod shared_vocab``, else a word of the document's
topic, ``shared_vocab + topic * topic_size + Zipf(zipf_topic) mod
topic_size``.  Equal (doc, word) tokens fold into one posting whose tf is
their count.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "CorpusModel",
    "Corpus",
    "Postings",
    "derive_seed",
    "generator",
    "zipf",
    "make_postings",
    "make_corpus",
    "payload_of",
    "col_of",
]

# Payloads are a bijection of the doc column over 40 bits, so a payload
# order never equals the column order a tie is broken by.
_P_BITS = 40
_P_MASK = (1 << _P_BITS) - 1
_P_MUL = 0x9E3779B97F  # odd: invertible modulo 2^40; about 0.618 x 2^40
_P_ADD = 0x5DEECE66D
_P_INV = pow(_P_MUL, -1, 1 << _P_BITS)


def payload_of(cols) -> np.ndarray:
    """The payload (row id) the benchmark gives the doc in column ``cols``:
    sealed docs are columns ``[0, N)``, inserted docs ``N, N + 1, ...`` in
    insertion order."""
    c = np.asarray(cols, dtype=np.uint64)
    return ((c * np.uint64(_P_MUL) + np.uint64(_P_ADD)) & np.uint64(_P_MASK)).astype(np.int64)


def col_of(payloads) -> np.ndarray:
    """The inverse of ``payload_of``; a payload outside 40 bits maps to -1."""
    p = np.asarray(payloads, dtype=np.int64)
    bad = (p < 0) | (p > _P_MASK)
    u = p.astype(np.uint64)
    c = ((u - np.uint64(_P_ADD)) * np.uint64(_P_INV)) & np.uint64(_P_MASK)
    return np.where(bad, -1, c.astype(np.int64))


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of random numbers of a run."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, tag))
    return gen


def zipf(a: float, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` draws of Zipf(a), a > 1, as int64: numpy's rejection
    algorithm (``random_zipf``), vectorised; draws above 2^62 are
    rejected, as numpy rejects those above its largest integer."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    am1 = a - 1.0
    b = 2.0 ** am1
    filled = 0
    while filled < n:
        m = int((n - filled) * 1.15) + 1024
        u = 1.0 - torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        v = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1.0) & (x <= 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        got = x[ok][: n - filled].to(torch.int64)
        out[filled : filled + got.numel()] = got
        filled += got.numel()
    return out


@dataclass(frozen=True)
class CorpusModel:
    n_docs: int
    mean_len: float
    len_sigma: float
    min_len: int
    vocab: int
    n_topics: int
    shared_vocab: int
    shared_token_share: float
    zipf_shared: float
    zipf_topic: float
    topics_sorted: bool

    @classmethod
    def from_config(cls, config: dict) -> "CorpusModel":
        m = config["corpus_model"]
        return cls(
            n_docs=int(config["n_docs"]),
            mean_len=float(config["mean_len"]),
            len_sigma=float(m["len_sigma"]),
            min_len=int(m["min_len"]),
            vocab=int(config["vocab"]),
            n_topics=int(config["n_topics"]),
            shared_vocab=int(m["shared_vocab"]),
            shared_token_share=float(m["shared_token_share"]),
            zipf_shared=float(m["zipf_shared"]),
            zipf_topic=float(m["zipf_topic"]),
            topics_sorted=bool(m["topics_sorted"]),
        )

    @property
    def topic_size(self) -> int:
        return (self.vocab - self.shared_vocab) // self.n_topics

    @property
    def len_scale(self) -> float:
        return self.mean_len / math.exp(self.len_sigma ** 2 / 2.0)


@dataclass
class Postings:
    """Postings of ``n`` documents in (doc, word) order, on the device:
    ``start`` [n+1] int64 each doc's span, ``tid`` and ``tf`` int64."""

    n: int
    start: torch.Tensor
    tid: torch.Tensor
    tf: torch.Tensor


def make_postings(model: CorpusModel, n: int, gen: torch.Generator, device) -> Postings:
    """``n`` documents of ``model``, drawn from ``gen``."""
    z = torch.randn(n, dtype=torch.float64, generator=gen, device=device)
    lengths = torch.floor(model.len_scale * torch.exp(model.len_sigma * z)).to(torch.int64)
    lengths = lengths.clamp_(min=model.min_len)
    topic = torch.randint(0, model.n_topics, (n,), generator=gen, device=device)
    if model.topics_sorted:
        topic = torch.sort(topic).values
    total = int(lengths.sum())
    doc_of = torch.repeat_interleave(torch.arange(n, device=device), lengths, output_size=total)
    shared = torch.rand(total, generator=gen, device=device) < model.shared_token_share
    n_shared = int(shared.sum())
    ids = torch.empty(total, dtype=torch.int64, device=device)
    ids[shared] = zipf(model.zipf_shared, n_shared, gen, device) % model.shared_vocab
    topical = ~shared
    ts = model.topic_size
    ids[topical] = (
        model.shared_vocab
        + topic[doc_of[topical]] * ts
        + zipf(model.zipf_topic, total - n_shared, gen, device) % ts
    )
    key = doc_of * model.vocab + ids
    del doc_of, ids, shared, topical
    uniq, counts = torch.unique(key, sorted=True, return_counts=True)
    del key
    doc = uniq // model.vocab
    tid = uniq % model.vocab
    start = torch.zeros(n + 1, dtype=torch.int64, device=device)
    start[1:] = torch.cumsum(torch.bincount(doc, minlength=n), 0)
    return Postings(n=n, start=start, tid=tid, tf=counts.to(torch.int64))


@dataclass
class Corpus:
    """The sealed corpus as host arrays in (word, doc) order, the raw
    input that the program's build and the reference both read, and its
    doc-major postings on the device for the query generator."""

    model: CorpusModel
    n_docs: int
    tid: np.ndarray  # [P] int64, ascending
    doc: np.ndarray  # [P] int64, ascending within a word
    tf: np.ndarray  # [P] int64
    by_doc: Postings  # device, (doc, word) order
    df: torch.Tensor  # [vocab] int64, device


def make_corpus(model: CorpusModel, seed: int, device) -> Corpus:
    gen = generator(seed, "corpus", device)
    post = make_postings(model, model.n_docs, gen, device)
    df = torch.bincount(post.tid, minlength=model.vocab)
    doc_of = torch.repeat_interleave(
        torch.arange(model.n_docs, device=device), post.start.diff(), output_size=post.tid.numel()
    )
    order = torch.argsort(post.tid * model.n_docs + doc_of)
    tid = post.tid[order].cpu().numpy()
    doc = doc_of[order].cpu().numpy()
    tf = post.tf[order].cpu().numpy()
    del order, doc_of
    return Corpus(model=model, n_docs=model.n_docs, tid=tid, doc=doc, tf=tf, by_doc=post, df=df)
