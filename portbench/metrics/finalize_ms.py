"""Facade finalize: mean ms of a batch's ``finalize()`` (the wait on the
card, the growing merge and the result lists, ``index/bm25index.py``);
the benchmark's span around each call."""

import numpy as np


def read(run):
    s = run.spans.get("finalize")
    return float(np.mean(s)) * 1e3 if s is not None and s.size else None
