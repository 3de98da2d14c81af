"""The program's own recorder (``vectorchord_bm25_tpu_torch/utils/tracing.py``)
as the per-layer metrics of its spans and counters read it.

The benchmark does not switch the recorder on.  A ``torch.profiler``
session does, for its length, so after a ``--trace 1`` run the recorder
holds the profiled steps alone: the ``profile_batches`` batches dispatched
and finalized while the profiler ran.  Each metric is a mean a batch over
the recorder's ``batches`` counter.  Where the program has no recorder, or
the recorder saw no batch or none of the metric's spans, the reader
returns None.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence


def snapshot() -> Optional[dict]:
    try:
        from vectorchord_bm25_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span_ms(keep: Callable[[Sequence[str]], bool]) -> Optional[float]:
    """Mean ms a batch of the spans whose path (root first) ``keep``
    accepts; spans on one path never nest, so their times add."""
    snap = snapshot()
    if snap is None:
        return None
    batches = snap["counters"].get("batches", 0)
    totals = [s["total_s"] for path, s in snap["spans"].items() if keep(path.split("/"))]
    if not batches or not totals:
        return None
    return 1e3 * sum(totals) / batches


def per_batch(counter: str) -> Optional[float]:
    """Counter ``counter`` a batch."""
    snap = snapshot()
    if snap is None:
        return None
    batches = snap["counters"].get("batches", 0)
    if not batches or counter not in snap["counters"]:
        return None
    return snap["counters"][counter] / batches
