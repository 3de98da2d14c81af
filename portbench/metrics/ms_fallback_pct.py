"""MaxScore tiers: the share of routed queries that no tier certified and
that the exhaustive sparse reduction served again (wasted tier work),
from ``last_ms_stats`` after each dispatch, summed over the window."""


def read(run):
    routed = run.counters.get("ms_routed_queries", 0)
    return 100.0 * run.counters.get("ms_fallback_queries", 0) / routed if routed else None
