"""The port's kernels and their wrappers.

Each wrapper module counts its calls in module globals named
``LAUNCHES`` or ``*_LAUNCHES``; ``launch_count()`` sums them.
"""

from __future__ import annotations

import sys

__all__ = ["launch_count"]

_WRAPPERS = (
    "blockmax_round", "exact_kernel", "score_kernel", "shard_kernels",
    "stream_kernel", "stream_rescore", "stream_sparse", "topk",
)


def launch_count() -> int:
    """The sum of every wrapper module's launch counters (a module not
    imported yet has launched nothing)."""
    total = 0
    for name in _WRAPPERS:
        module = sys.modules.get(f"{__name__}.{name}")
        if module is not None:
            total += sum(v for k, v in vars(module).items() if k.endswith("LAUNCHES"))
    return total
