"""Block-Max rounds: mean ms a batch that the host waits on the card
inside the pruning loop, the program's spans ``vcbm25.blockmax.flag``
(each round's blocking read of B1-select's flag, ``search/blockmax.py``),
over the profiled steps (``_program.py``)."""

from ._program import span_ms


def read(run):
    return span_ms(lambda path: path[-1] == "vcbm25.blockmax.flag")
