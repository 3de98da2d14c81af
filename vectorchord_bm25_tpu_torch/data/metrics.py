"""IR quality metrics: NDCG@k and recall@k (trec_eval conventions).

These evaluate retrieval runs against BEIR qrels the same way the
reference's published table was produced (NDCG@10 from
`xhluca/bm25-benchmarks`, which uses the standard trec_eval definitions;
reference README.md:396-402):

- DCG@k = sum_{i=1..k} (2^rel_i - 1) / log2(i + 1), NDCG = DCG / IDCG
  with the ideal ordering taken from the qrels;
- recall@k = |relevant docs in top-k| / |relevant docs| (graded rels > 0
  count as relevant), micro-averaged per query then macro-averaged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

__all__ = ["ndcg_at_k", "recall_at_k", "evaluate_run"]


def _dcg(gains: Sequence[float]) -> float:
    return sum(
        (2.0**g - 1.0) / math.log2(i + 2.0) for i, g in enumerate(gains)
    )


def ndcg_at_k(
    run: Dict[str, List[str]], qrels: Dict[str, Dict[str, int]], k: int
) -> float:
    """Mean NDCG@k over queries with at least one relevant document.

    run: query_id -> ranked doc-id list (best first).
    """
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        if not any(r > 0 for r in rels.values()):
            continue
        ranked = run.get(qid, [])[:k]
        gains = [float(rels.get(d, 0)) for d in ranked]
        ideal = sorted((float(r) for r in rels.values() if r > 0), reverse=True)[:k]
        idcg = _dcg(ideal)
        total += _dcg(gains) / idcg if idcg > 0 else 0.0
        n += 1
    return total / n if n else 0.0


def recall_at_k(
    run: Dict[str, List[str]], qrels: Dict[str, Dict[str, int]], k: int
) -> float:
    """Mean recall@k over queries with at least one relevant document."""
    total, n = 0.0, 0
    for qid, rels in qrels.items():
        relevant = {d for d, r in rels.items() if r > 0}
        if not relevant:
            continue
        ranked = set(run.get(qid, [])[:k])
        total += len(ranked & relevant) / len(relevant)
        n += 1
    return total / n if n else 0.0


def evaluate_run(
    run: Dict[str, List[str]],
    qrels: Dict[str, Dict[str, int]],
    ks=(10, 100, 1000),
) -> Dict[str, float]:
    out = {"ndcg@10": round(ndcg_at_k(run, qrels, 10), 5)}
    for k in ks:
        out[f"recall@{k}"] = round(recall_at_k(run, qrels, k), 5)
    return out
