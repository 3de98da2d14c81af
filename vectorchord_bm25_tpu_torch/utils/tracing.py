"""The program's own spans and counters, for an operator who wants to see
where a batch's host time goes.

Off by default.  ``enable()`` turns the recorder on; a ``torch.profiler``
session turns it on for the session's length as well, so a profile's
window has the program's totals beside its timeline.  While it is on:

- ``span(name)`` times a block with ``perf_counter_ns`` and records its
  name, start, end, parent span, thread and batch id.  Spans nest per
  thread; a span with no batch id takes its parent's.  Running totals
  (count, total and self time, self being the span less its children) are
  kept per path of names from the root, and the raw records in a ring of
  ``RING`` entries, so memory stays bounded however long the process
  serves.  While a profiler session is active each span also enters
  ``profiling.annotate(name)``, which puts it on the profiler's timeline
  beside the card's kernels;
- ``count(name, n)`` adds ``n`` to a counter.

While it is off, ``span`` returns a shared no-op context (no allocation,
no clock read) and ``count`` does nothing.  ``snapshot()`` reads the
totals, counters and ring; ``reset()`` clears them.  Every name the
program records starts with ``vcbm25.``.  The module imports no torch, so
the host build's modules, which spawned workers load without it, can
record spans too.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import sys
import threading
import time
from typing import Optional

__all__ = [
    "enable", "disable", "reset", "snapshot", "active", "span", "traced",
    "count", "next_batch", "RING",
]

#: Raw span records kept (the oldest are dropped first).
RING = 1 << 16

_on = False
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
_batches = itertools.count(1)
_totals: dict = {}  # path tuple -> [count, total_ns, self_ns]
_counters: collections.Counter = collections.Counter()
_ring: collections.deque = collections.deque(maxlen=RING)
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording (none can be
    where torch's profiler module is not loaded)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod is not None and mod._is_profiler_enabled


def active() -> bool:
    """Whether spans and counters are being recorded: ``enable()`` was
    called, or a ``torch.profiler`` session is recording."""
    return _on or _profiling()


def reset() -> None:
    """Drop every total, counter and record (open spans still close)."""
    with _lock:
        _totals.clear()
        _counters.clear()
        _ring.clear()


def snapshot() -> dict:
    """``{"spans": {path: {"count", "total_s", "self_s"}}, "counters":
    {name: n}, "records": [...]}``; a path is the span's name after its
    ancestors', joined by ``/``; a record is ``(id, name, start_ns,
    end_ns, parent id or None, thread id, batch id or None)``."""
    with _lock:
        spans = {
            "/".join(path): {
                "count": c, "total_s": total * 1e-9, "self_s": own * 1e-9,
            }
            for path, (c, total, own) in _totals.items()
        }
        return {"spans": spans, "counters": dict(_counters), "records": list(_ring)}


def next_batch() -> int:
    """A new batch id (a batch's dispatch and finalize spans share one)."""
    return next(_batches)


def count(name: str, n: int = 1) -> None:
    if _on or _profiling():
        with _lock:
            _counters[name] += n


def span(name: str, batch: Optional[int] = None):
    """A context timing the block as span ``name``."""
    if _on or _profiling():
        return _Span(name, batch)
    return _OFF


def traced(name: str):
    """Decorator: every call of the function is span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Span:
    __slots__ = ("name", "batch", "sid", "parent", "path", "child_ns", "note", "t0")

    def __init__(self, name, batch):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.sid = next(_ids)
        self.parent = up.sid if up is not None else None
        self.path = up.path + (self.name,) if up is not None else (self.name,)
        if self.batch is None and up is not None:
            self.batch = up.batch
        self.child_ns = 0
        self.note = None
        if _profiling():
            from .profiling import annotate

            self.note = annotate(self.name)
            self.note.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        if self.note is not None:
            self.note.__exit__(*exc)
        with _lock:
            tot = _totals.get(self.path)
            if tot is None:
                tot = _totals[self.path] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
            _ring.append(
                (self.sid, self.name, self.t0, t1, self.parent,
                 threading.get_ident(), self.batch)
            )
        return False
