"""The benchmark of ``vectorchord_bm25_tpu_torch``, the PyTorch and CUDA port.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m portbench.run --workload trec-covid.search --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric or kernel lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``,
``metrics/<metric>.py`` and ``roofline/<kernel>.py``.  The plain reference
that decides ``correct`` is ``reference/``; it imports nothing of the port.
"""
