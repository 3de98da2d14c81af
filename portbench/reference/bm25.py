"""BM25 top-k in plain PyTorch, worked out again from raw postings.

The semantics the port's configurations state (VectorChord-BM25's,
``crates/bm25/src/bm25.rs``):

- ``idf(t) = ln((N + 1) / (df(t) + 0.5))`` over the sealed documents;
- a posting scores ``idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * L /
  avgdl))``, where ``L`` is the document's length quantised to one byte
  (the fieldnorm) and read back through the 256-entry table below, and
  ``avgdl`` is the sealed documents' mean length;
- a query scores a document by the sum over its distinct words;
- inserted documents are scored with the sealed statistics, and a word
  the sealed documents lack adds nothing to them;
- deleted documents score nothing;
- a result is the at most ``k`` documents that score above 0, by score
  descending, then by column ascending (sealed docs first, then inserted
  docs in insertion order).

Everything is computed in ``dtype``: float64 for the reference, a lower
precision for the control.  Nothing here imports the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FIELDNORM_TO_LENGTH", "fieldnorm", "Reference", "top_lists", "gather"]


def _fieldnorm_table() -> np.ndarray:
    """Byte -> length: the identity below 40, then eight steps a doubling
    (``crates/bm25/src/bm25.rs:15-283``)."""
    table = np.arange(256, dtype=np.int64)
    for byte in range(40, 256):
        g, i = divmod(byte - 40, 8)
        table[byte] = 24 + (1 << (g + 4)) + i * (1 << (g + 1))
    return table


FIELDNORM_TO_LENGTH = _fieldnorm_table()


def fieldnorm(lengths: torch.Tensor) -> torch.Tensor:
    """The largest byte whose length is at most ``lengths``."""
    table = torch.as_tensor(FIELDNORM_TO_LENGTH, device=lengths.device)
    return torch.searchsorted(table, lengths, right=True) - 1


def _csr(tid: torch.Tensor, vocab: int) -> np.ndarray:
    off = np.zeros(vocab + 1, dtype=np.int64)
    off[1:] = np.cumsum(torch.bincount(tid, minlength=vocab).cpu().numpy())
    return off


class Reference:
    """BM25 over a sealed corpus and, optionally, inserted documents.

    ``tid``, ``doc``, ``tf``: the sealed postings, sorted by word, on the
    host; ``inserted``: ``(start [E+1], tid, tf)`` doc-major postings of
    the documents inserted later, which take columns ``N .. N + E - 1`` in
    that order."""

    def __init__(
        self,
        tid: np.ndarray,
        doc: np.ndarray,
        tf: np.ndarray,
        n_docs: int,
        vocab: int,
        k1: float,
        b: float,
        device,
        dtype=torch.float64,
        inserted: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ):
        if tid.size > 1 and np.any(tid[1:] < tid[:-1]):
            raise ValueError("sealed postings must be sorted by word")
        self.device = torch.device(device)
        self.dtype = dtype
        self.n_docs = int(n_docs)
        dev = self.device
        t = torch.from_numpy(np.ascontiguousarray(tid, dtype=np.int64)).to(dev)
        d = torch.from_numpy(np.ascontiguousarray(doc, dtype=np.int64)).to(dev)
        f = torch.from_numpy(np.ascontiguousarray(tf, dtype=np.int64)).to(dev)
        self.df = torch.bincount(t, minlength=vocab)
        lengths = torch.zeros(self.n_docs, dtype=torch.int64, device=dev).index_add_(0, d, f)
        self.avgdl = float(lengths.sum().item()) / float(self.n_docs)
        n = float(self.n_docs)
        idf = torch.log((n + 1.0) / (self.df.to(torch.float64) + 0.5))
        # s0 = idf * (k1 + 1) a word; s1 = k1 * (1 - b + b * L / avgdl) a doc.
        self.s0 = (idf * (k1 + 1.0)).to(dtype)
        self.k1, self.b = k1, b
        self.off = _csr(t, vocab)
        self.doc = d
        self.score = self._scores(t, f, self._s1(lengths)[d])
        self.n_ins = 0
        if inserted is not None:
            start, e_tid, e_tf = inserted
            e = start.size - 1
            self.n_ins = e
            et = torch.from_numpy(np.ascontiguousarray(e_tid, dtype=np.int64)).to(dev)
            ef = torch.from_numpy(np.ascontiguousarray(e_tf, dtype=np.int64)).to(dev)
            counts = torch.from_numpy(np.diff(start)).to(dev)
            edoc = torch.repeat_interleave(torch.arange(e, device=dev), counts, output_size=et.numel())
            e_len = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(0, edoc, ef)
            known = self.df[et] > 0
            et, ef, edoc = et[known], ef[known], edoc[known]
            order = torch.argsort(et * max(e, 1) + edoc)
            et, ef, edoc = et[order], ef[order], edoc[order]
            self.e_off = _csr(et, vocab)
            self.e_doc = self.n_docs + edoc
            self.e_score = self._scores(et, ef, self._s1(e_len)[edoc])

    def _s1(self, lengths: torch.Tensor) -> torch.Tensor:
        table = torch.as_tensor(FIELDNORM_TO_LENGTH, dtype=torch.float64, device=self.device)
        ln = table[fieldnorm(lengths)]
        return (self.k1 * (1.0 - self.b + self.b * ln / self.avgdl)).to(self.dtype)

    def _scores(self, t, f, s1):
        tf = f.to(self.dtype)
        return tf * self.s0[t] / (tf + s1)

    @property
    def n_cols(self) -> int:
        return self.n_docs + self.n_ins

    def block_rows(self) -> int:
        """Queries a block, so that a block's [B, columns] sums take about
        512 MB."""
        return max(1, (1 << 29) // (8 * (self.n_cols + 1)))

    def sums(
        self,
        queries: Sequence[np.ndarray],
        visible: Optional[Sequence[int]] = None,
        deleted: Optional[Sequence[np.ndarray]] = None,
    ) -> torch.Tensor:
        """[B, columns] scores of a block of queries (word-id arrays).
        ``visible[i]``: inserted docs query i sees; ``deleted[i]``: the
        columns deleted before query i."""
        acc = torch.zeros(len(queries), self.n_cols, dtype=self.dtype, device=self.device)
        for i, words in enumerate(queries):
            row = acc[i]
            for w in np.asarray(words, dtype=np.int64):
                lo, hi = int(self.off[w]), int(self.off[w + 1])
                if hi > lo:
                    row.index_add_(0, self.doc[lo:hi], self.score[lo:hi])
                if self.n_ins:
                    lo, hi = int(self.e_off[w]), int(self.e_off[w + 1])
                    if hi > lo:
                        row.index_add_(0, self.e_doc[lo:hi], self.e_score[lo:hi])
            if self.n_ins and visible is not None:
                row[self.n_docs + int(visible[i]) :] = 0
            if deleted is not None and len(deleted[i]):
                row[torch.from_numpy(np.asarray(deleted[i], dtype=np.int64)).to(self.device)] = 0
        return acc


def top_lists(acc: torch.Tensor, k: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each row's top ``k`` (scores as float64, columns): scores above 0,
    by score descending, then column ascending."""
    kk = min(k, acc.shape[1])
    kth = torch.topk(acc, kk, dim=1).values[:, -1]
    floor = torch.where(kth > 0, kth, torch.full_like(kth, float("inf")))
    cand = (acc >= floor[:, None]) | ((acc > 0) & (kth[:, None] <= 0))
    r, c = torch.nonzero(cand, as_tuple=True)
    s = acc[r, c].to(torch.float64).cpu().numpy()
    r, c = r.cpu().numpy(), c.cpu().numpy()
    order = np.lexsort((c, -s, r))
    r, c, s = r[order], c[order], s[order]
    bounds = np.searchsorted(r, np.arange(acc.shape[0] + 1))
    return [
        (s[bounds[i] : bounds[i + 1]][:k], c[bounds[i] : bounds[i + 1]][:k])
        for i in range(acc.shape[0])
    ]


def gather(acc: torch.Tensor, cols: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Each row's scores at ``cols[i]`` as float64; a column outside the
    row reads 0."""
    width = max((len(c) for c in cols), default=0)
    if width == 0:
        return [np.zeros(0, dtype=np.float64) for _ in cols]
    pad = np.full((len(cols), width), -1, dtype=np.int64)
    for i, c in enumerate(cols):
        pad[i, : len(c)] = c
    ok = (pad >= 0) & (pad < acc.shape[1])
    idx = torch.from_numpy(np.where(ok, pad, 0)).to(acc.device)
    vals = torch.gather(acc, 1, idx).to(torch.float64).cpu().numpy()
    vals = np.where(ok, vals, 0.0)
    return [vals[i, : len(c)] for i, c in enumerate(cols)]
