"""Facade finalize: mean ms a batch of building its ``SearchHit`` lists,
the program's span ``vcbm25.facade.hits`` (``index/bm25index.py``), over
the profiled steps (``_program.py``)."""

from ._program import span_ms


def read(run):
    return span_ms(lambda path: path[-1] == "vcbm25.facade.hits")
