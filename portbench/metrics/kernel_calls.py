"""Kernels: kernel wrapper calls a batch, the program's counter
``kernel_calls`` (the change of ``ops.launch_count()`` over each
``search_batch_async``), over the profiled steps (``_program.py``)."""

from ._program import per_batch


def read(run):
    return per_batch("kernel_calls")
