"""Diagnose dataset-mode oracle-parity mismatches (counterpart of
``tools/parity_diag.py``, on a port index).

Counts by the rule of ``data/harness.py::oracle_rank_parity`` (the one
helper ``oracle_mismatch`` decides for both) and, for each counted
mismatch, records the engine / f64-oracle / tie-grouped rankings plus the
float64 relative score gap at every divergence, to distinguish:

- engine bug: diverging docs have CLEARLY different f64 scores
  (rel gap >> 1e-6) — a real rank error ("real gap");
- f32 boundary swap: diverging docs differ by ~f32 resolution — the
  engine's f32 comparison legitimately flipped (the engine scores in
  f32 exactly like the reference, bm25.rs), but the flipped order
  happens to match neither the f64 order nor the doc-asc tie order
  ("f32 boundary", a gap of at most 4e-6).

Usage: python -m vectorchord_bm25_tpu_torch.tools.parity_diag \\
           --cache .benchcache --dataset synthetic:msmarco-1m \\
           [--audit 256] [--k 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

__all__ = ["diagnose", "main"]

#: The largest float64 relative gap an f32 comparison can flip.
F32_BOUNDARY = 4e-6


def diagnose(index, queries, k: int = 10, rtol: float = 1e-6) -> List[dict]:
    """One record per query that ``oracle_rank_parity`` counts as a
    mismatch (so ``len(diagnose(...))`` is its count): ``query`` (the
    position in ``queries``), ``n_terms``, the ``engine``, ``f64`` and
    ``tie_grouped`` payload rankings, and ``ranks``: at every rank where
    the engine differs from the tie-grouped ranking (the f64 one where
    their lengths differ), the two payloads, their f64 scores, the
    relative gap and its class (``"f32 boundary"`` or ``"real gap"``), or
    ``class`` None where a doc is outside the f64 top 200."""
    from ..data.harness import oracle_mismatch

    seg = index.sealed
    records = []
    for qi, query in enumerate(queries):
        hits = index.search(query, k=k)
        got = [h.payload for h in hits]
        miss = oracle_mismatch(seg, query, got, k, rtol)
        if miss is None:
            continue
        expect, expect_tied, scores64, docs = miss
        pay2doc = {int(seg.doc_payload[i]): int(i) for i in docs[:200]}
        ref = expect_tied if len(expect_tied) == len(got) else expect
        ranks = []
        for r, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                continue
            da, db = pay2doc.get(a), pay2doc.get(b)
            if da is None or db is None:
                ranks.append({"rank": r, "engine": a, "expected": b, "class": None})
                continue
            sa, sb = float(scores64[da]), float(scores64[db])
            rel = abs(sa - sb) / max(abs(sa), abs(sb), 1e-12)
            ranks.append(
                {
                    "rank": r, "engine": a, "expected": b,
                    "engine_s64": sa, "expected_s64": sb, "rel_gap": rel,
                    "class": "f32 boundary" if rel <= F32_BOUNDARY else "real gap",
                }
            )
        records.append(
            {
                "query": qi,
                "n_terms": int(query.keys.shape[0]),
                "engine": got,
                "f64": expect,
                "tie_grouped": expect_tied,
                "ranks": ranks,
            }
        )
    return records


def report_lines(records, n_queries: int) -> List[str]:
    """The reference tool's printed lines for ``diagnose``'s records."""
    lines = []
    for rec in records:
        lines.append(f"query {rec['query']} ({rec['n_terms']} terms):")
        lines.append(f"  engine : {rec['engine']}")
        lines.append(f"  f64    : {rec['f64']}")
        lines.append(f"  tie-grp: {rec['tie_grouped']}")
        for d in rec["ranks"]:
            if d["class"] is None:
                lines.append(
                    f"  rank {d['rank']}: payload {d['engine']} vs "
                    f"{d['expected']} (doc not in top-200)"
                )
                continue
            lines.append(
                f"  rank {d['rank']}: engine {d['engine']} "
                f"s64={d['engine_s64']:.9f} vs expected {d['expected']} "
                f"s64={d['expected_s64']:.9f} rel_gap={d['rel_gap']:.3e}"
                + (
                    "  <- f32 boundary"
                    if d["class"] == "f32 boundary"
                    else "  <- REAL GAP"
                )
            )
    lines.append(
        f"mismatches (same rule as the bench audit): "
        f"{len(records)}/{n_queries}"
    )
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache", required=True)
    ap.add_argument("--dataset", default="synthetic:msmarco-1m")
    ap.add_argument("--audit", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.harness import make_queries
    from ..data.stream_synth import generate_streaming
    from ..index.storage import open_index
    from ..utils.device import as_device

    device = as_device(args.device)
    shape = args.dataset.split(":", 1)[1]
    ds = generate_streaming(shape)
    index = open_index(
        os.path.join(args.cache, f"dsidx_{shape}"), device=device
    )
    queries = make_queries(ds, index)[: args.audit]
    records = diagnose(index, queries, k=args.k)
    for line in report_lines(records, len(queries)):
        print(line)


if __name__ == "__main__":
    main()
