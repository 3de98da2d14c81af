"""Token interning and document/query term vectors.

Terms are interned to stable 16-byte keys exactly like the reference
(crates/bm25/src/vector.rs:19-35):

- strings shorter than 16 bytes that contain no NUL byte are embedded
  verbatim (zero-padded on the right);
- anything else is hashed with a blake3 *keyed* hash (key = the 32-byte
  index seed) truncated to 16 bytes, with the last byte forced nonzero so
  hashed keys can never collide with an embedded short string's padding.

The seed is generated per index (reference crates/bm25/src/seed.rs:18-29)
so interning is stable for the index's lifetime but corpus-independent.

`Document` and `Query` mirror the reference's invariants
(vector.rs:49-134): documents hold sorted-unique keys with nonzero term
frequencies; document length is the saturating sum of frequencies;
queries are sorted-unique key sets (query-side term frequency is ignored
by BM25 scoring, matching the reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

WIDTH = 16  # token-key width in bytes (reference crates/bm25/src/lib.rs:37)

__all__ = [
    "WIDTH",
    "random_seed",
    "intern",
    "intern_int_id",
    "Document",
    "Query",
]

_U32_SATURATE = np.uint64(0xFFFFFFFF)


def _keyed_hash16(seed: bytes, data: bytes) -> bytes:
    try:
        from ..native import loader

        fn = loader.blake3_keyed_hash16()
        if fn is not None:
            return fn(seed, data)
    except Exception:
        pass
    from .blake3 import blake3_keyed_hash

    return blake3_keyed_hash(seed, data, 32)[:WIDTH]


def random_seed() -> bytes:
    """Fresh 32-byte index seed (reference crates/bm25/src/seed.rs:18-22)."""
    return os.urandom(32)


def intern(seed: bytes, token: bytes) -> bytes:
    """Intern one token to its 16-byte key (reference vector.rs:19-35)."""
    if isinstance(token, str):
        token = token.encode("utf-8")
    if len(token) < WIDTH and b"\x00" not in token:
        return token + b"\x00" * (WIDTH - len(token))
    h = bytearray(_keyed_hash16(seed, token))
    if h[WIDTH - 1] == 0:
        h[WIDTH - 1] = 1
    return bytes(h)


def intern_int_id(token_id: int) -> bytes:
    """Intern an integer token id (the 0.2.x `bm25vector` generation, where
    postings are keyed by external-tokenizer ids; reference README.md:443-460).

    Encoded big-endian into the first 4 bytes so key order == numeric order.
    """
    if not (0 <= token_id < 2**32):
        raise ValueError(f"token id out of range: {token_id}")
    return int(token_id).to_bytes(4, "big") + b"\x00" * (WIDTH - 4)


def _to_key_array(keys) -> np.ndarray:
    """Normalize a sequence of 16-byte keys to a numpy |S16 array."""
    arr = np.asarray(keys, dtype=f"S{WIDTH}")
    return arr


@dataclass(frozen=True)
class Document:
    """A sorted-unique (key, term-frequency) vector (reference vector.rs:49-94)."""

    keys: np.ndarray  # [L] dtype |S16, strictly increasing
    values: np.ndarray  # [L] uint32, all nonzero

    def __post_init__(self):
        keys = _to_key_array(self.keys)
        values = np.asarray(self.values, dtype=np.uint32)
        if keys.shape != values.shape or keys.ndim != 1:
            raise ValueError("keys/values must be parallel 1-D arrays")
        if keys.size > 1 and not np.all(keys[:-1] < keys[1:]):
            raise ValueError("document keys must be strictly increasing")
        if np.any(values == 0):
            raise ValueError("document term frequencies must be nonzero")
        object.__setattr__(self, "keys", keys)
        object.__setattr__(self, "values", values)

    @classmethod
    def from_pairs(cls, seed: bytes, pairs) -> "Document":
        """Build from an iterable of (token, count); tokens are interned and
        duplicate keys are merged with saturating addition (matching the
        reference's tsvector cast, src/datatype/tsvector.rs:107-127)."""
        merged: dict[bytes, int] = {}
        for token, count in pairs:
            key = intern(seed, token)
            merged[key] = merged.get(key, 0) + int(count)
        return cls._from_merged(merged)

    @classmethod
    def from_token_counts(cls, seed: bytes, counts: dict) -> "Document":
        return cls.from_pairs(seed, counts.items())

    @classmethod
    def from_int_ids(cls, ids) -> "Document":
        """0.2.x generation: a bag of integer token ids; duplicates aggregate
        into frequencies (reference README.md:458-460 `int[]::bm25vector`)."""
        merged: dict[bytes, int] = {}
        for token_id in ids:
            key = intern_int_id(int(token_id))
            merged[key] = merged.get(key, 0) + 1
        return cls._from_merged(merged)

    @classmethod
    def _from_merged(cls, merged: dict) -> "Document":
        items = sorted(merged.items())
        keys = np.asarray([k for k, _ in items], dtype=f"S{WIDTH}")
        values = np.asarray(
            [min(v, 0xFFFFFFFF) for _, v in items], dtype=np.uint32
        )
        mask = values != 0
        return cls(keys=keys[mask], values=values[mask])

    def __len__(self) -> int:
        return int(self.keys.size)

    def length(self) -> int:
        """Document length = saturating sum of term frequencies
        (reference vector.rs:77-83)."""
        total = int(np.sum(self.values, dtype=np.uint64))
        return min(total, 0xFFFFFFFF)


@dataclass(frozen=True)
class Query:
    """A sorted-unique key set (reference vector.rs:96-134)."""

    keys: np.ndarray  # [T] dtype |S16, strictly increasing

    def __post_init__(self):
        keys = _to_key_array(self.keys)
        if keys.ndim != 1:
            raise ValueError("keys must be a 1-D array")
        if keys.size > 1 and not np.all(keys[:-1] < keys[1:]):
            raise ValueError("query keys must be strictly increasing")
        object.__setattr__(self, "keys", keys)

    @classmethod
    def from_tokens(cls, seed: bytes, tokens) -> "Query":
        """Intern, sort and dedup query tokens (reference
        src/datatype/tsvector.rs:96-105)."""
        keys = sorted({intern(seed, t) for t in tokens})
        return cls(keys=np.asarray(keys, dtype=f"S{WIDTH}"))

    @classmethod
    def from_int_ids(cls, ids) -> "Query":
        keys = sorted({intern_int_id(int(i)) for i in ids})
        return cls(keys=np.asarray(keys, dtype=f"S{WIDTH}"))

    @classmethod
    def from_document(cls, document: Document) -> "Query":
        return cls(keys=document.keys.copy())

    def __len__(self) -> int:
        return int(self.keys.size)
