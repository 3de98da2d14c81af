"""Block-Max rounds: pruning rounds a batch, the program's counter
``blockmax_rounds`` (the rounds of ``_blockmax_kernel``'s loop that
scored and merged, ``search/blockmax.py``), over the profiled steps
(``_program.py``)."""

from ._program import per_batch


def read(run):
    return per_batch("blockmax_rounds")
