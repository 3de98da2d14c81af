"""The comparison that decides ``correct``.

A sampled query's hit list, ``[(score, column), ...]`` as the program
returned it (payloads mapped back to columns), is held to the plain
reference's float64 result on the same inputs:

- ``score_rel_err``: the largest gap between a returned score and the
  reference's float64 score of the same document, relative to the latter;
  a returned document the reference scores 0 (not a match, deleted, not
  yet inserted, or a payload the benchmark never gave) reads 1;
- ``rank_errors``: positions where the returned document is not the
  reference's and the two documents' reference scores differ by more than
  ``tie`` (relative), plus every hit too many or too few, every document
  returned twice, and every adjacent pair out of the order (score
  descending, then column ascending) by the returned scores;
- ``missing_results``: queries of the window that got no hit list at all.

``tie`` is twice the score limit: two documents whose reference scores lie
that close may come in either order, since each returned score may be off
by the limit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Readings", "compare_one", "compare"]


@dataclass
class Readings:
    score_rel_err: float = 0.0
    rank_errors: int = 0
    missing_results: int = 0
    queries: int = 0
    failed_queries: int = 0
    worst: List[str] = field(default_factory=list)

    def values(self) -> dict:
        return {
            "score_rel_err": self.score_rel_err,
            "rank_errors": self.rank_errors,
            "missing_results": self.missing_results,
        }


def compare_one(
    got: Optional[Sequence[Tuple[float, int]]],
    want: Tuple[np.ndarray, np.ndarray],
    want_of_got: np.ndarray,
    tie: float,
) -> Tuple[int, float]:
    """(rank errors, largest relative score gap) of one query."""
    want_s, want_c = want
    if got is None:
        return max(1, len(want_c)), 0.0
    errors = abs(len(got) - len(want_c))
    worst = 0.0
    cols = [c for _, c in got]
    errors += len(cols) - len(set(cols))
    for r, (score, col) in enumerate(got):
        ref = float(want_of_got[r])
        if ref <= 0.0:
            worst = max(worst, 1.0)
        else:
            worst = max(worst, abs(float(score) - ref) / ref)
        if r < len(want_c) and col != int(want_c[r]):
            if ref <= 0.0 or abs(ref - float(want_s[r])) > tie * float(want_s[r]):
                errors += 1
        if r and not (
            got[r - 1][0] > score or (got[r - 1][0] == score and got[r - 1][1] < col)
        ):
            errors += 1
    return errors, worst


def compare(
    got: Sequence[Optional[Sequence[Tuple[float, int]]]],
    want: Sequence[Tuple[np.ndarray, np.ndarray]],
    want_of_got: Sequence[np.ndarray],
    score_limit: float,
    labels: Optional[Sequence[str]] = None,
) -> Readings:
    """Readings over a sample of queries."""
    out = Readings(queries=len(got))
    tie = 2.0 * score_limit
    for i, (g, w, wg) in enumerate(zip(got, want, want_of_got)):
        errors, worst = compare_one(g, w, wg, tie)
        out.rank_errors += errors
        out.score_rel_err = max(out.score_rel_err, worst)
        if errors or worst > score_limit:
            out.failed_queries += 1
            if len(out.worst) < 3:
                label = labels[i] if labels is not None else str(i)
                out.worst.append(
                    f"{label}: {errors} rank errors, score gap {worst:.3e}; got "
                    f"{list(g)[:4] if g is not None else None}, want "
                    f"{list(zip(w[0][:4].tolist(), w[1][:4].tolist()))}"
                )
    return out
