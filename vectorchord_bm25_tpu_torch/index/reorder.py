"""Document-id reordering at build time.

Block-max pruning skips a doc range only when the sum of its per-term
score bounds cannot beat the running threshold — which requires ranges to
*differ*.  Reassigning doc ids so similar documents cluster tightens
per-range bounds dramatically (the standard trick behind production BMW
deployments; the reference keeps heap insertion order and relies on
natural crawl locality).

Strategies:
- "none":      keep insertion order (the reference's behavior);
- "fieldnorm": sort by quantized document length ascending — short docs
  (highest tf-scores) cluster in early ranges, so the top-k threshold
  rises immediately and long-doc ranges prune against it; within a
  length class, insertion order is kept (stable);
- "term":      lexicographic by dominant term then length — clusters
  topically similar docs (a cheap approximation of recursive graph
  bisection).

Payloads travel with their documents, so reordering is invisible to the
caller except for tie-break order between equal scores.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..models.fieldnorm import length_to_fieldnorm
from ..text.intern import Document

__all__ = ["reorder_documents", "REORDER_STRATEGIES"]

REORDER_STRATEGIES = ("none", "fieldnorm", "term")


def reorder_documents(
    documents: Sequence[Document],
    payloads: np.ndarray,
    strategy: str = "none",
) -> Tuple[List[Document], np.ndarray]:
    if strategy not in REORDER_STRATEGIES:
        raise ValueError(
            f"unknown reorder strategy {strategy!r}; "
            f"expected one of {REORDER_STRATEGIES}"
        )
    if strategy == "none" or len(documents) == 0:
        return list(documents), np.asarray(payloads, dtype=np.int64)

    n = len(documents)
    fns = np.fromiter(
        (int(length_to_fieldnorm(d.length())) for d in documents),
        dtype=np.int64,
        count=n,
    )
    if strategy == "fieldnorm":
        order = np.argsort(fns, kind="stable")
    else:  # "term"
        # Dominant term = highest-tf key (first on ties); cluster by it,
        # then by length.
        dom = np.zeros(n, dtype="S16")
        for i, d in enumerate(documents):
            if len(d):
                dom[i] = d.keys[int(np.argmax(d.values))]
        order = np.lexsort((fns, dom))
    docs = [documents[int(i)] for i in order]
    return docs, np.asarray(payloads, dtype=np.int64)[order]
