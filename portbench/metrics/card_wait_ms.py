"""Facade finalize: mean ms a batch that ``finalize()`` waits on the card,
the program's spans ``vcbm25.stream.wait`` (the blocking copies of the
results to the host, ``search/stream.py``) under
``vcbm25.facade.finalize``, the sealed and the growing engine's both, over
the profiled steps (``_program.py``)."""

from ._program import span_ms


def read(run):
    return span_ms(lambda path: path[-1] == "vcbm25.stream.wait" and "vcbm25.facade.finalize" in path)
