"""Hierarchical exact top-k over dense accumulators (counterpart of ``ops/topk.py``).

The reference's algorithm, step by step (``vectorchord_bm25_tpu/ops/topk.py``):

1. per 1024-doc block, the max of the masked accumulator (``acc > 0`` or
   -inf) — one streaming pass over ``[Q, M]``;
2. the k best blocks of ``[Q, T]``, ties to the lower block id, re-sorted
   ascending so the gathered lanes stay in doc order;
3. gather those blocks and the ragged tail, and take the final k.

Below 2^17 docs (or with too few blocks) it is one masked top-k, as in
the reference.

``lax.top_k`` breaks ties by the lowest index; ``torch.topk`` promises no
tie order.  Both selections therefore run on a packed int64 key (see
``lex_topk``): the f32 bits of a positive score order like the score, so
``(inf_bits - bits) << 32 | id`` ascending is (score desc, id asc), and
every key is distinct.

On a CUDA tensor ``dense_topk`` makes one call into ``csrc/dense_topk.cu``:
in the hierarchical branch a streaming pass writes one packed key a
1024-doc block, then one block of threads a query selects the k best
blocks, reads them and the tail once, and keeps the k best packed keys in
shared memory behind a threshold (the k-th best block maximum: no doc
below it can enter); past 2,048 selected keys a row is sorted in chunks
and merged by rank.  The selection never leaves the kernels: no key
matrix is written and no library selection runs.  On a CPU tensor it
runs ``dense_topk_plain``.

The streaming pass reads the whole accumulator once (1.07 GB for a
``[2048, 131073]`` dispatch) for a compare and a max a value: it is bound
by device-memory bytes, so it loads 16 B a thread and needs rows that
start 16-B aligned (``new_accumulator`` pads the row stride to a multiple
of 4 floats).
"""

from __future__ import annotations

import torch

__all__ = [
    "dense_topk",
    "dense_topk_plain",
    "lex_topk",
    "new_accumulator",
    "select_keys",
]

# Number of dense_topk calls that launched the CUDA kernels; chip_smoke.py
# reads it to show the main path went through them.
LAUNCHES = 0

# Mirrors of csrc/dense_topk.cu's kMaxChunks and kCap: past them the kernel
# needs a scratch row for the chosen block ids or the selected keys.
_MAX_CHUNKS = 1024
_CAP = 2048

# Below this many docs the reference takes one masked top-k (topk.py:53).
_HIER_MIN_DOCS = 1 << 17

# Bits of +inf in float32: a key half above every finite positive score.
_F32_INF_BITS = 0x7F800000
_LOW32 = 0xFFFFFFFF


def _pack(scores, ids):
    """int64 keys whose ascending order is (score desc, id asc); scores
    that are not > 0 (pads, -inf) all share the top half."""
    bits = scores.view(torch.int32)
    hi = torch.where(scores > 0, _F32_INF_BITS - bits, _F32_INF_BITS)
    return (hi.long() << 32) | ids.long()


def _unpack(keys):
    """(scores f32, ids i32) of packed keys; a pad key gives -inf."""
    hi = keys >> 32
    bits = (_F32_INF_BITS - hi).int()
    scores = torch.where(
        hi == _F32_INF_BITS, float("-inf"), bits.view(torch.float32)
    )
    return scores, (keys & _LOW32).int()


def lex_topk(all_s, all_d, k: int):
    """The k best (score desc, doc asc) entries of each row.

    Scores are > 0 or -inf, so the f32 bit pattern of a live score orders
    like the score; packing (inf_bits - bits, doc) into one int64 key
    turns the two-key order of the reference's ``lax.sort`` into one
    ``topk`` on distinct keys (pads are identical, so their order is moot).
    """
    key = _pack(all_s, all_d)
    _, pick = torch.topk(key, k, dim=1, largest=False, sorted=True)
    return all_s.gather(1, pick), all_d.gather(1, pick)


def _select(keys, k: int):
    """The k smallest packed keys of each row, ascending."""
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).values


def select_keys(keys, k: int):
    """(scores f32, ids i32) of the k smallest packed keys of each row:
    ``lex_topk``'s selection, for callers that wrote the keys themselves."""
    return _unpack(_select(keys, k))


def new_accumulator(n_q: int, n_docs: int, device, zero: bool = True) -> torch.Tensor:
    """A ``[n_q, n_docs + 1]`` f32 accumulator whose rows start 16-B
    aligned: a view of ``[n_q, stride]`` with the stride rounded up to a
    multiple of 4 floats (pass 1's vector loads need it, padding
    included).  Zeroed, or with ``zero=False`` uninitialised, for a kernel
    that writes every cell of the ``[n_q, stride]`` rows itself."""
    stride = (n_docs + 1 + 3) & ~3
    make = torch.zeros if zero else torch.empty
    base = make((n_q, stride), dtype=torch.float32, device=device)
    return base[:, : n_docs + 1]


def _hierarchical(m: int, k: int, n_docs: int, block: int) -> bool:
    t = m // block
    return not (n_docs < _HIER_MIN_DOCS or t < max(2 * k, 8))


def dense_topk_plain(acc, k: int, n_docs: int, block: int = 1024):
    """Plain PyTorch version of ``dense_topk`` (reference ``topk.py:43-91``)."""
    q, m = acc.shape
    dev = acc.device
    if not _hierarchical(m, k, n_docs, block):
        cols = acc[:, :n_docs]
        ids = torch.arange(n_docs, dtype=torch.int32, device=dev).expand(q, -1)
        return select_keys(_pack(cols, ids), k)

    t = m // block
    neg_inf = float("-inf")
    body = acc[:, : t * block].reshape(q, t, block)
    # Pass 1: per-block max with the score > 0 mask fused into the reduce.
    bmax = torch.where(body > 0.0, body, neg_inf).amax(dim=2)  # [Q, T]
    blk_ids = torch.arange(t, dtype=torch.int32, device=dev).expand(q, -1)
    # Pass 2: candidate blocks (ties -> lower block id), doc-ordered.
    bi = (_select(_pack(bmax, blk_ids), k) & _LOW32).sort(dim=1).values

    # Pass 3: gather the candidates and the ragged tail [t*block, m), and
    # reduce exactly.  The tail alone also masks docs >= n_docs.
    lane = torch.arange(block, dtype=torch.int64, device=dev)
    docs = (bi[:, :, None] * block + lane).reshape(q, k * block)
    vals = body.reshape(q, t * block).gather(1, docs)
    tail_docs = torch.arange(t * block, m, dtype=torch.int64, device=dev)
    tail = acc[:, t * block :]
    tail = torch.where(tail_docs < n_docs, tail, 0.0)
    keys = torch.cat(
        [_pack(vals, docs), _pack(tail, tail_docs.expand(q, -1))], dim=1
    )
    return select_keys(keys, k)


def _check(acc, k, n_docs, block):
    if acc.dtype != torch.float32:
        raise TypeError(f"acc must be torch.float32, got {acc.dtype}")
    if acc.dim() != 2:
        raise ValueError(f"acc must be [Q, M], got shape {tuple(acc.shape)}")
    q, m = acc.shape
    if not 0 <= n_docs <= m:
        raise ValueError(f"n_docs {n_docs} outside [0, {m}]")
    if block <= 0 or block % 128:
        raise ValueError(f"block must be a positive multiple of 128, got {block}")
    if not 1 <= k <= n_docs:
        raise ValueError(f"k must be in [1, n_docs = {n_docs}], got {k}")


def _check_out(out, acc, k):
    q = acc.shape[0]
    for x, dtype, name in zip(out, (torch.float32, torch.int32), ("scores", "ids")):
        if x.dtype != dtype or tuple(x.shape) != (q, k) or x.device != acc.device:
            raise ValueError(f"out {name} must be [{q}, {k}] {dtype} on {acc.device}")
        if not x.is_contiguous():
            raise ValueError(f"out {name} must be contiguous")


def dense_topk(acc, k: int, n_docs: int, block: int = 1024, out=None):
    """Exact top-k of ``where(acc > 0, acc, -inf)`` per row.

    acc: [Q, M] float32 with M >= n_docs; columns past n_docs must hold
    values <= 0.  Returns (scores [Q, k] f32 desc, ids [Q, k] i32); rows
    with fewer than k positive docs pad with -inf, whose ids follow the
    reference's lowest-index rule but mean nothing (callers mask on
    isfinite).  out: an optional (scores, ids) pair of contiguous [Q, k]
    tensors on acc's device that the result is written into and that is
    returned (the kernel writes there; the plain version's result is copied
    in).  A CUDA tensor launches the kernels or raises; a CPU tensor runs
    the plain version."""
    global LAUNCHES

    _check(acc, k, n_docs, block)
    if out is not None:
        _check_out(out, acc, k)
    if acc.device.type == "cpu":
        got = dense_topk_plain(acc, k, n_docs, block)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1])
        return out
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    q, m = acc.shape
    stride = acc.stride(0)
    if acc.stride(1) != 1 or stride % 4 or acc.data_ptr() % 16:
        raise ValueError(
            "acc rows must be contiguous and start 16-byte aligned (row "
            "stride a multiple of 4 floats); allocate it with new_accumulator"
        )

    from ._build import library

    lib = library()
    dev = acc.device
    hier = _hierarchical(m, k, n_docs, block)
    t = m // block if hier else 0

    def scratch(shape, dtype, needed):
        return torch.empty(shape, dtype=dtype, device=dev) if needed else None

    if out is None:
        scores = torch.empty((q, k), dtype=torch.float32, device=dev)
        ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    else:
        scores, ids = out
    bkeys = scratch((q, t), torch.int64, hier)
    bi = scratch((q, k), torch.int32, hier and k > _MAX_CHUNKS)
    sel = scratch((q, k), torch.int64, k > _CAP)
    nsel = scratch((q,), torch.int32, k > _CAP)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bm25_dense_topk(
            acc.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (bkeys, bi, sel, nsel)),
            scores.data_ptr(), ids.data_ptr(), q, m, n_docs, k, block, stride,
            int(hier), stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_topk kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return scores, ids
