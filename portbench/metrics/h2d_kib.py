"""Facade and engine dispatch: KiB a batch that the serving path uploads
to the card, the program's counter ``h2d_bytes`` (every host array
``search/stream.py`` hands to the device after its build), over the
profiled steps (``_program.py``)."""

from ._program import per_batch


def read(run):
    value = per_batch("h2d_bytes")
    return None if value is None else value / 1024.0
