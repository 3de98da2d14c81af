"""Whole step (the client's closed loop: ``Query`` objects, dispatch,
finalize): queries of the batches finalized in the window over its
seconds, both outside the profiled steps.  The quantity of ``qps``, for
cells whose host-clock spread is too wide for an end-to-end bound."""


def read(run):
    queries, seconds = run.window
    return queries / seconds if queries and seconds > 0 else None
