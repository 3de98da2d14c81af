"""A traffic mix's writes: the inserts and deletes each step makes.

A mix with ``"writes"`` inserts ``preload_docs`` new documents at set-up,
then before each step's batch inserts ``inserts_per_step`` more and
deletes ``deletes_per_step`` live documents drawn at random from every
column inserted so far (sealed and inserted).  The new documents come
from the configuration's corpus model under their own seed.  The
schedule depends on the seed alone, so the reference replays it: a batch
of step ``s`` sees every insert and delete made up to and including step
``s``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .corpus import derive_seed

__all__ = ["Writes", "NEVER"]

NEVER = np.iinfo(np.int64).max


@dataclass
class Writes:
    n_docs: int
    n_extra: int
    preload: int
    inserts: int
    deletes: int
    seed: int

    def __post_init__(self):
        self.rng = np.random.default_rng(derive_seed(self.seed, "deletes"))
        cols = self.n_docs + self.n_extra
        self.delete_step = np.full(cols, NEVER, dtype=np.int64)
        self.inserted = 0

    @classmethod
    def from_spec(cls, spec: dict, n_docs: int, steps: int, seed: int) -> "Writes":
        """The schedule for at most ``steps`` steps."""
        preload = int(spec["preload_docs"])
        inserts = int(spec["inserts_per_step"])
        return cls(
            n_docs=n_docs,
            n_extra=preload + inserts * steps,
            preload=preload,
            inserts=inserts,
            deletes=int(spec["deletes_per_step"]),
            seed=seed,
        )

    def preload_docs(self) -> range:
        """The documents inserted at set-up (extra-doc indices)."""
        self.inserted = self.preload
        return range(self.preload)

    def step(self, s: int):
        """Step ``s``'s (extra-doc indices to insert, columns to delete)."""
        lo = self.inserted
        hi = lo + self.inserts
        if hi > self.n_extra:
            raise RuntimeError("the traffic ran out of documents to insert; raise the cell's qps_cap")
        self.inserted = hi
        live_cols = self.n_docs + hi
        if int(np.count_nonzero(self.delete_step[:live_cols] == NEVER)) < 2 * self.deletes:
            raise RuntimeError("the traffic ran out of live documents to delete")
        picked = []
        while len(picked) < self.deletes:
            c = int(self.rng.integers(0, live_cols))
            if self.delete_step[c] == NEVER:
                self.delete_step[c] = s
                picked.append(c)
        return range(lo, hi), np.asarray(picked, dtype=np.int64)

    def visible(self, s: int) -> int:
        """Inserted documents a batch of step ``s`` sees."""
        return self.preload + self.inserts * (s + 1)

    def deleted(self, s: int) -> np.ndarray:
        """Columns deleted before a batch of step ``s``."""
        return np.flatnonzero(self.delete_step <= s)
