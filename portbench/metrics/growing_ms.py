"""Growing segment: mean ms a batch of the growing segment's dispatch and
finalize, the program's spans ``vcbm25.growing.dispatch`` (its engine's
rebuilds, the queries' re-keying, its engine's dispatch, the host tail
top-k) and ``vcbm25.growing.finalize`` (``index/growing.py``), over the
profiled steps (``_program.py``)."""

from ._program import span_ms

NAMES = ("vcbm25.growing.dispatch", "vcbm25.growing.finalize")


def read(run):
    return span_ms(lambda path: path[-1] in NAMES)
