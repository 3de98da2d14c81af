"""MaxScore tiers: the share of a batch's queries that ``auto`` routes to
MaxScore (``search/stream.py`` ``_ms_route``), from the sealed engine's
``last_ms_stats`` after each dispatch, summed over the window."""


def read(run):
    total = run.counters.get("ms_batch_queries", 0)
    return 100.0 * run.counters.get("ms_routed_queries", 0) / total if total else None
