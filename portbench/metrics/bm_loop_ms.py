"""Block-Max rounds: mean ms a batch of the pruning loop on the host, the
program's span ``vcbm25.blockmax.rounds`` (each round's B1-select,
P1-tf or P1 and B1-merge launches and its flag read, ``search/blockmax.py``),
over the profiled steps (``_program.py``)."""

from ._program import span_ms


def read(run):
    return span_ms(lambda path: path[-1] == "vcbm25.blockmax.rounds")
