"""Synthetic corpus and query generators (copies of ``bench.py:65-213``).

The generators ``chip_smoke.py`` drives the port with, copied so the port
needs nothing of the JAX package or of ``bench.py``:

- ``synth_corpus_postings``: flat (key, doc, tf) postings of a corpus with
  Zipf term frequencies, log-normal doc lengths and topical clustering;
- ``synth_queries_fast``: idf-weighted query terms drawn from random docs;
- ``synth_queries_from_segment``: queries drawn from a sealed segment's
  token table, ``mix="informative"`` or ``"heavy"``.

Their output depends on numpy's generators, so it can differ between
numpy versions; ``tests/test_torch_standalone.py`` holds each equal to
``bench.py``'s on the same seed.
"""

from __future__ import annotations

import numpy as np

from ..text.intern import Query

__all__ = [
    "synth_corpus_postings",
    "synth_queries_fast",
    "synth_queries_from_segment",
]


def synth_corpus_postings(
    n_docs: int, vocab: int, avg_len: int, seed: int = 0, n_topics: int = 64
):
    """Vectorized corpus generator for large scales: returns flat
    (keys |S16, doc_ids, tfs) postings plus per-doc CSR offsets, with the
    same topical structure as synth_corpus but no per-doc Python loops."""
    rng = np.random.default_rng(seed)
    shared = vocab // 5
    topic_sz = (vocab - shared) // n_topics
    lengths = np.maximum(
        4, (avg_len * rng.lognormal(0.0, 0.6, size=n_docs)).astype(np.int64)
    )
    total = int(lengths.sum())
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    topic_of = np.sort(rng.integers(0, n_topics, size=n_docs))
    z = rng.zipf(1.3, size=total)
    is_shared = rng.random(total) < 0.4
    ids = np.where(
        is_shared,
        z % shared,
        shared + topic_of[doc_of] * topic_sz + (z % topic_sz),
    )
    # Dedup (doc, id) -> tf counts.
    order = np.lexsort((ids, doc_of))
    d_s, i_s = doc_of[order], ids[order]
    boundary = np.empty(total, dtype=bool)
    boundary[0] = True
    boundary[1:] = (d_s[1:] != d_s[:-1]) | (i_s[1:] != i_s[:-1])
    starts = np.flatnonzero(boundary)
    tfs = np.diff(np.append(starts, total)).astype(np.int64)
    u_docs = d_s[starts]
    u_ids = i_s[starts]
    # Encode int ids as 16-byte keys (big-endian in the first 4 bytes).
    keys_u8 = np.zeros((u_ids.size, 16), dtype=np.uint8)
    be = u_ids.astype(">u4").view(np.uint8).reshape(-1, 4)
    keys_u8[:, :4] = be
    keys = keys_u8.reshape(-1).view("S16")
    doc_start = np.zeros(n_docs + 1, dtype=np.int64)
    np.add.at(doc_start, u_docs + 1, 1)
    np.cumsum(doc_start, out=doc_start)
    return keys, u_docs, tfs, doc_start


def synth_queries_fast(
    keys, doc_start, segment, n_queries: int, terms: int = 4, seed: int = 1
):
    """Query sampling for the fast corpus: idf-weighted terms from random
    documents (same distribution as synth_queries)."""
    rng = np.random.default_rng(seed)
    n = segment.n_docs
    out = []
    for _ in range(n_queries):
        di = int(rng.integers(0, n))
        lo, hi = int(doc_start[di]), int(doc_start[di + 1])
        if hi - lo == 0:
            out.append(Query(keys=np.zeros(0, dtype="S16")))
            continue
        dkeys = keys[lo:hi]
        tids = segment.lookup_tokens(dkeys)
        dfs = np.where(tids >= 0, segment.token_df[np.maximum(tids, 0)], 1)
        w = np.log((n + 1.0) / (dfs + 0.5))
        w = np.maximum(w, 1e-6) ** 2
        w /= w.sum()
        m = min(terms, hi - lo)
        picks = rng.choice(hi - lo, size=m, replace=False, p=w)
        out.append(Query(keys=np.sort(dkeys[np.sort(picks)])))
    return out


def synth_queries_from_segment(
    segment, n_queries: int, vocab: int, terms: int = 4, seed: int = 1,
    n_topics: int = 64, mix: str = "informative",
):
    """Query sampling from the sealed segment alone — no corpus postings
    required, so a cached multi-million-doc segment can grow its query
    set without regenerating the corpus (hours on one host core).

    Matches synth_queries_fast's structure: an anchor topical term drawn
    df-weighted (appearing in a random doc), companions drawn
    df*idf^2-weighted from the SAME topic slice (the synthetic corpora
    place each topic's vocabulary in a contiguous id range, so query
    terms co-occur in documents like real keyword queries), plus one
    common distractor term half the time.

    mix='informative' (default): distractors drawn df*idf^2-weighted
    like synth_queries_fast — every term carries signal, the flat-
    impact worst case for skip-based pruning.  mix='heavy': EVERY
    query gets 1-2 distractors drawn df-weighted from the Zipf head —
    the huge-posting-list common-word case where the reference's WAND
    machinery (search.rs:151-280) earns its keep."""
    rng = np.random.default_rng(seed)
    keys = segment.token_keys
    u8 = keys.view(np.uint8).reshape(-1, 16)[:, :4].astype(np.uint32)
    ids = (u8[:, 0] << 24) | (u8[:, 1] << 16) | (u8[:, 2] << 8) | u8[:, 3]
    df = segment.token_df.astype(np.float64)
    n = segment.n_docs
    idf2 = np.log((n + 1.0) / (df + 0.5)) ** 2
    shared = vocab // 5
    topic_sz = (vocab - shared) // n_topics
    t_idx = np.flatnonzero(ids >= shared)
    c_idx = np.flatnonzero(ids < shared)
    topic_of = (ids[t_idx] - shared) // topic_sz
    t_start = np.searchsorted(topic_of, np.arange(n_topics + 1))
    p_anchor = df[t_idx] / df[t_idx].sum()
    w_top = np.maximum(df[t_idx] * idf2[t_idx], 1e-12)
    w_com = np.maximum(df[c_idx] * idf2[c_idx], 1e-12)
    heavy = mix == "heavy"
    anchors = rng.choice(t_idx.size, size=n_queries, p=p_anchor)
    commons = (
        c_idx[rng.choice(c_idx.size, size=n_queries, p=w_com / w_com.sum())]
        if c_idx.size
        else np.zeros(n_queries, dtype=np.int64)
    )
    p_head = df[c_idx] / df[c_idx].sum() if c_idx.size else None
    out = []
    for qi in range(n_queries):
        a = int(anchors[qi])
        t = int(topic_of[a])
        lo, hi = int(t_start[t]), int(t_start[t + 1])
        picks = [int(t_idx[a])]
        if heavy and c_idx.size:
            m_common = min(1 + int(rng.random() < 0.5), max(terms - 1, 1))
        elif c_idx.size and terms > 2 and rng.random() < 0.5:
            m_common = 1
        else:
            m_common = 0
        m_top = min(terms - 1 - m_common, hi - lo - 1)
        if m_top > 0:
            w = w_top[lo:hi].copy()
            w[a - lo] = 0.0
            s = w.sum()
            if s > 0:
                sel = rng.choice(hi - lo, size=m_top, replace=False, p=w / s)
                picks.extend(int(t_idx[lo + j]) for j in sel)
        if m_common:
            if heavy:
                sel = rng.choice(
                    c_idx.size, size=m_common, replace=False, p=p_head
                )
                picks.extend(int(c_idx[j]) for j in sel)
            else:
                picks.append(int(commons[qi]))
        out.append(Query(keys=np.sort(keys[np.asarray(picks)])))
    return out

