"""Facade and engine dispatch: mean ms of ``Bm25Index.search_batch_async``
a batch (``index/bm25index.py``, the engine's planning in
``search/stream.py``, the growing segment's in ``index/growing.py``);
the benchmark's span around each call."""

import numpy as np


def read(run):
    s = run.spans.get("dispatch")
    return float(np.mean(s)) * 1e3 if s is not None and s.size else None
