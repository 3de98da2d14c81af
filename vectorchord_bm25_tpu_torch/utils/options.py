"""Index options and search-time configuration.

Mirrors the reference's layered config system (SURVEY.md §5):

- build-time options `k1`/`b` with the same validation ranges as the
  reference (crates/bm25/src/types.rs:20-45: k1 in [1.2, 2.0], b in [0, 1],
  defaults 1.2 / 0.75);
- search-time options `limit`/`prefilter` (reference reloptions,
  src/index/bm25/am/mod.rs:99-131) with session-level overrides that win
  only when explicitly set (reference GUC precedence, src/index/gucs.rs:113-145).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["IndexOptions", "SearchOptions", "SessionConfig"]


@dataclass(frozen=True)
class IndexOptions:
    """Build-time BM25 parameters (reference crates/bm25/src/types.rs:20-45)."""

    k1: float = 1.2
    b: float = 0.75

    def __post_init__(self):
        if not (1.2 <= self.k1 <= 2.0):
            raise ValueError(f"k1 must be within [1.2, 2.0], got {self.k1}")
        if not (0.0 <= self.b <= 1.0):
            raise ValueError(f"b must be within [0.0, 1.0], got {self.b}")


@dataclass(frozen=True)
class SearchOptions:
    """Per-index search defaults (reference reloptions `limit`, `prefilter`).

    limit: default number of results when the caller does not pass k
        (0 means "no default set" and the caller must supply k, mirroring
        the reference's "number of needed rows is set to 0" error,
        src/index/bm25/scanners/default.rs:114-116).
    prefilter: evaluate the user filter inside the retrieval loop so the
        top-k threshold stays honest under filtering (reference
        src/index/fetcher.rs:103-216).
    """

    limit: int = 0
    prefilter: bool = False

    def __post_init__(self):
        if not (0 <= self.limit <= 65535):
            raise ValueError(f"limit must be within [0, 65535], got {self.limit}")


@dataclass
class SessionConfig:
    """Session-level overrides (reference GUCs, src/index/gucs.rs:18-60).

    A session value overrides the per-index option only when explicitly set
    (reference gucs.rs:113-145); `None` means "not set".
    """

    enable_scan: bool = True
    limit: Optional[int] = None
    prefilter: Optional[bool] = None

    def resolve_limit(self, index_options: SearchOptions) -> int:
        if self.limit is not None:
            return self.limit
        return index_options.limit

    def resolve_prefilter(self, index_options: SearchOptions) -> bool:
        if self.prefilter is not None:
            return self.prefilter
        return index_options.prefilter


#: Process-wide default session (analogous to the GUC state).
DEFAULT_SESSION = SessionConfig()
