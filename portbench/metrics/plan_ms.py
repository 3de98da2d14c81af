"""Facade and engine dispatch: mean ms a batch of the sealed engine's host
planning, the program's spans ``vcbm25.stream.lookup`` (``_term_windows``),
``vcbm25.stream.route`` (``_ms_route``) and ``vcbm25.stream.plan`` (the
dispatches' assembly, their uploads and launches; ``search/stream.py``)
outside the growing segment's, over the profiled steps (``_program.py``)."""

from ._program import span_ms

NAMES = ("vcbm25.stream.lookup", "vcbm25.stream.route", "vcbm25.stream.plan")


def read(run):
    return span_ms(
        lambda path: path[-1] in NAMES and not any(p.startswith("vcbm25.growing.") for p in path)
    )
