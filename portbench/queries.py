"""Query generation on the device, from a traffic mix's parameters.

Two query models, the repo's two generators vectorised (each draws
without replacement by adding Gumbel noise to log weights and taking
the top entries, which is the same distribution as drawing one at a time):

- ``doc_sampled`` (``synth_queries_fast``): a uniformly drawn document,
  and ``terms`` of its words weighted by ``max(idf, 1e-6)^2``;
- ``topic`` (``synth_queries_from_segment``): an anchor word of a topic
  drawn by df, companions from the same topic weighted by ``df * idf^2``,
  and common words: with ``mix="heavy"`` one or two drawn by df from the
  shared head, otherwise one in two queries gets one drawn by
  ``df * idf^2``.

df is the benchmark's own, counted from its postings.  A query is its
sorted distinct word ids; the result is a host CSR ``(start [Q+1], tid)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .corpus import Corpus, generator

__all__ = ["make_queries"]

_CHUNK_CELLS = 1 << 26


def _gumbel(shape, gen, device):
    u = torch.rand(shape, dtype=torch.float64, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-300)))


def _csr(rows: torch.Tensor) -> tuple:
    """[Q, W] word ids with -1 pads -> host CSR of sorted distinct ids."""
    rows = torch.sort(rows, dim=1).values
    dup = torch.zeros_like(rows, dtype=torch.bool)
    dup[:, 1:] = rows[:, 1:] == rows[:, :-1]
    rows = rows.masked_fill(dup, -1)
    rows = torch.sort(rows, dim=1).values
    keep = rows >= 0
    counts = keep.sum(1)
    start = np.zeros(rows.shape[0] + 1, dtype=np.int64)
    start[1:] = np.cumsum(counts.cpu().numpy())
    return start, rows[keep].cpu().numpy()


def _doc_sampled(corpus: Corpus, n: int, terms: int, gen, device):
    post = corpus.by_doc
    n_docs = corpus.n_docs
    idf = torch.log((n_docs + 1.0) / (corpus.df.to(torch.float64) + 0.5))
    w_log = 2.0 * torch.log(idf.clamp(min=1e-6))
    d = torch.randint(0, n_docs, (n,), generator=gen, device=device)
    lo = post.start[d]
    cnt = post.start[d + 1] - lo
    width = int(cnt.max())
    out = torch.full((n, terms), -1, dtype=torch.int64, device=device)
    step = max(1, _CHUNK_CELLS // max(width, 1))
    pos = torch.arange(width, device=device)
    for q0 in range(0, n, step):
        sl = slice(q0, min(n, q0 + step))
        valid = pos[None, :] < cnt[sl, None]
        idx = (lo[sl, None] + pos[None, :]).clamp_(max=post.tid.numel() - 1)
        words = post.tid[idx]
        key = w_log[words] + _gumbel(words.shape, gen, device)
        key = key.masked_fill(~valid, -float("inf"))
        top = torch.topk(key, min(terms, width), dim=1)
        picked = torch.gather(words, 1, top.indices)
        picked = picked.masked_fill(torch.isinf(top.values), -1)
        out[sl, : picked.shape[1]] = picked
    return out


def _draw(weights: torch.Tensor, n: int, gen, device) -> torch.Tensor:
    """``n`` indices drawn with replacement in proportion to ``weights``."""
    cdf = torch.cumsum(weights.to(torch.float64), 0)
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=weights.numel() - 1)


def _topic(corpus: Corpus, n: int, terms: int, mix: str, gen, device):
    model = corpus.model
    n_docs = corpus.n_docs
    sv, ts, nt = model.shared_vocab, model.topic_size, model.n_topics
    df = corpus.df.to(torch.float64)
    idf2 = torch.log((n_docs + 1.0) / (df + 0.5)) ** 2
    present = df > 0
    w_top = torch.where(present, (df * idf2).clamp(min=1e-12), torch.zeros_like(df))
    heavy = mix == "heavy"
    # Anchors: a topical word drawn by df.
    topical_df = df[sv : sv + nt * ts]
    a = _draw(topical_df, n, gen, device)
    anchor = sv + a
    topic = a // ts
    # How many common words each query gets.
    coin = torch.rand(n, generator=gen, device=device) < 0.5
    if heavy:
        m_common = torch.clamp(1 + coin.to(torch.int64), max=max(terms - 1, 1))
    else:
        m_common = (coin & (terms > 2)).to(torch.int64)
    # Companions from the anchor's topic, df * idf^2, the anchor excluded.
    width = min(max(terms - 1, 1), ts)
    comp = torch.full((n, width), -1, dtype=torch.int64, device=device)
    span = torch.arange(ts, device=device)[None, :]
    rank = torch.arange(width, device=device)[None, :]
    step = max(1, _CHUNK_CELLS // ts)
    for q0 in range(0, n, step):
        sl = slice(q0, min(n, q0 + step))
        slot = sv + topic[sl, None] * ts + span
        w = w_top[slot].masked_fill(slot == anchor[sl, None], 0.0)
        m_top = torch.minimum(terms - 1 - m_common[sl], (w > 0).sum(1))
        top = torch.topk(torch.log(w) + _gumbel(w.shape, gen, device), width, dim=1)
        picked = torch.gather(slot, 1, top.indices)
        comp[sl] = picked.masked_fill((rank >= m_top[:, None]) | torch.isinf(top.values), -1)
    # Common words from the shared head.
    head_df = df[:sv]
    if heavy:
        c1 = _draw(head_df, n, gen, device)
        c2 = _draw(head_df, n, gen, device)
        same = c2 == c1
        while bool(same.any()):
            c2[same] = _draw(head_df, int(same.sum()), gen, device)
            same = c2 == c1
        commons = torch.stack([c1, c2], 1)
    else:
        commons = _draw(w_top[:sv], n, gen, device)[:, None]
    crank = torch.arange(commons.shape[1], device=device)[None, :]
    commons = commons.masked_fill(crank >= m_common[:, None], -1)
    return torch.cat([anchor[:, None], comp, commons], 1)


def make_queries(corpus: Corpus, n: int, spec: dict, seed: int, device):
    """``n`` queries of the mix ``spec`` (a traffic file's ``queries``)."""
    gen = generator(seed, "queries", device)
    terms = int(spec["terms"])
    if spec["model"] == "doc_sampled":
        rows = _doc_sampled(corpus, n, terms, gen, device)
    elif spec["model"] == "topic":
        rows = _topic(corpus, n, terms, spec.get("mix", "informative"), gen, device)
    else:
        raise ValueError(f"unknown query model {spec['model']!r}")
    return _csr(rows)
