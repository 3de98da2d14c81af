"""Pure-Python BLAKE3 (hash + keyed hash), implemented from the public spec.

Used as the portable fallback for token interning (the reference interns
long/NUL-containing lexemes with a blake3 *keyed* hash of the index seed,
crates/bm25/src/vector.rs:19-35).  The JAX package also has a native C++
implementation; the port interns with this module alone, which gives the
same keys.

Only the features the engine needs are implemented: one-shot hashing of a
byte string to a 32-byte digest, in plain and keyed modes.
"""

from __future__ import annotations

__all__ = ["blake3_hash", "blake3_keyed_hash"]

_IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

_MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

_CHUNK_START = 1 << 0
_CHUNK_END = 1 << 1
_PARENT = 1 << 2
_ROOT = 1 << 3
_KEYED_HASH = 1 << 4

_CHUNK_LEN = 1024
_BLOCK_LEN = 64

_U32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _U32


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _U32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _U32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _U32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _U32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state, m):
    # Columns.
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    # Diagonals.
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _permute(m):
    return [m[_MSG_PERMUTATION[i]] for i in range(16)]


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3],
        cv[4], cv[5], cv[6], cv[7],
        _IV[0], _IV[1], _IV[2], _IV[3],
        counter & _U32, (counter >> 32) & _U32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r != 6:
            m = _permute(m)
    return [
        state[0] ^ state[8], state[1] ^ state[9],
        state[2] ^ state[10], state[3] ^ state[11],
        state[4] ^ state[12], state[5] ^ state[13],
        state[6] ^ state[14], state[7] ^ state[15],
        state[8] ^ cv[0], state[9] ^ cv[1],
        state[10] ^ cv[2], state[11] ^ cv[3],
        state[12] ^ cv[4], state[13] ^ cv[5],
        state[14] ^ cv[6], state[15] ^ cv[7],
    ]


def _words_from_block(block: bytes):
    block = block + b"\x00" * (_BLOCK_LEN - len(block))
    return [int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16)]


def _chunk_output(key_words, chunk: bytes, chunk_counter: int, flags: int):
    """Process one <=1024-byte chunk; returns (cv, last_block_words,
    last_block_len, last_flags) so the caller can apply ROOT if needed."""
    cv = list(key_words)
    blocks = [chunk[i : i + _BLOCK_LEN] for i in range(0, len(chunk), _BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    n = len(blocks)
    for i, block in enumerate(blocks[: n - 1]):
        block_flags = flags | (_CHUNK_START if i == 0 else 0)
        cv = _compress(cv, _words_from_block(block), chunk_counter, _BLOCK_LEN, block_flags)[:8]
    last = blocks[n - 1]
    last_flags = flags | (_CHUNK_START if n == 1 else 0) | _CHUNK_END
    return cv, _words_from_block(last), len(last), last_flags


def _root_bytes(cv, block_words, block_len, flags, out_len: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < out_len:
        words = _compress(cv, block_words, counter, block_len, flags | _ROOT)
        for w in words:
            out += int(w).to_bytes(4, "little")
        counter += 1
    return bytes(out[:out_len])


def _parent_words(left_cv, right_cv):
    return list(left_cv) + list(right_cv)


def _hash_internal(data: bytes, key_words, flags: int, out_len: int) -> bytes:
    chunks = [data[i : i + _CHUNK_LEN] for i in range(0, len(data), _CHUNK_LEN)]
    if not chunks:
        chunks = [b""]

    if len(chunks) == 1:
        cv, block_words, block_len, last_flags = _chunk_output(key_words, chunks[0], 0, flags)
        return _root_bytes(cv, block_words, block_len, last_flags, out_len)

    # Compute every chunk's chaining value.
    cvs = []
    for i, chunk in enumerate(chunks):
        cv, block_words, block_len, last_flags = _chunk_output(key_words, chunk, i, flags)
        cvs.append(_compress(cv, block_words, i, block_len, last_flags)[:8])

    # Build the binary tree: left subtree is the largest power of two of
    # chunks strictly less than the total (per the spec), applied bottom-up
    # pairwise which yields the same topology for full layers; the standard
    # iterative formulation pairs adjacent CVs per level, carrying the odd
    # one up unchanged.
    while len(cvs) > 2:
        next_cvs = []
        for i in range(0, len(cvs) - 1, 2):
            words = _parent_words(cvs[i], cvs[i + 1])
            next_cvs.append(_compress(key_words, words, 0, _BLOCK_LEN, flags | _PARENT)[:8])
        if len(cvs) % 2 == 1:
            next_cvs.append(cvs[-1])
        cvs = next_cvs

    words = _parent_words(cvs[0], cvs[1])
    return _root_bytes(list(key_words), words, _BLOCK_LEN, flags | _PARENT, out_len)


def blake3_hash(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash of `data`."""
    return _hash_internal(bytes(data), list(_IV), 0, out_len)


def blake3_keyed_hash(key: bytes, data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 keyed hash; `key` must be exactly 32 bytes."""
    if len(key) != 32:
        raise ValueError("blake3 key must be 32 bytes")
    key_words = [int.from_bytes(key[4 * i : 4 * i + 4], "little") for i in range(8)]
    return _hash_internal(bytes(data), key_words, _KEYED_HASH, out_len)
