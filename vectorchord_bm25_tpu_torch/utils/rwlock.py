"""Readers-writer lock for index concurrency.

The reference synchronizes concurrent backends with per-page buffer locks
plus a dedicated lock page: `maintain` takes it exclusive while
`bulkdelete` and searches take it shared (crates/bm25/src/maintain.rs:44,
bulkdelete.rs:34).  The array-resident rebuild needs only a host-side
readers-writer lock with the same discipline: searches and point
mutations run shared; the maintain/merge generation swap runs exclusive.
"""

from __future__ import annotations

import threading

__all__ = ["RWLock"]


class RWLock:
    """Writer-preferring readers-writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _ReadGuard:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            self.lock.acquire_read()
            return self

        def __exit__(self, *exc):
            self.lock.release_read()
            return False

    class _WriteGuard:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            self.lock.acquire_write()
            return self

        def __exit__(self, *exc):
            self.lock.release_write()
            return False

    def read(self) -> "_ReadGuard":
        return self._ReadGuard(self)

    def write(self) -> "_WriteGuard":
        return self._WriteGuard(self)
