"""Growing segment: mean ms of one ``Bm25Index.insert`` in the window
(``index/growing.py``); the benchmark's span around each call."""

import numpy as np


def read(run):
    s = run.spans.get("insert")
    return float(np.mean(s)) * 1e3 if s is not None and s.size else None
