"""The stream engine's sparse reduction (counterpart of M3 ``_stream_sparse``).

``stream_sparse_topk`` is the reference's ``_stream_sparse``
(``search/stream.py:309-363``): for a ``[Q, P]`` matrix of window ids it
decodes and scores every lane, sorts each row by doc, sums each doc's run
and keeps the k best run sums, ties to the lower doc.

On a CUDA tensor it makes one launch of SP-stream
(``csrc/sparse_merge.cu`` on ``csrc/sparse_merge.cuh``), which does all of
it without writing a lane: it needs each row's segments (``seg_off``, one
a (query, term occurrence), from the planning) and reads no sort or
selection of torch.  On a CPU tensor it runs the plain version, the
parent's composition, which is the reference step for step:

1. ``stream_sparse_decode`` (S3): every ``[Q, P*128]`` lane as (doc, score),
   dead and pad lanes as ``(n_docs, 0.0)``;
2. ``torch.sort(stable=True)`` of each row by doc, the scores gathered
   along: within a run the lanes stay in window order, which is term order;
3. ``sparse_combine`` (S4): the reference's Hillis-Steele run sums, and at
   each run's last lane the packed selection key of ``ops/topk.py::_pack``;
4. ``select_keys``: the k smallest keys per row, as ``lex_topk`` selects.

S3 and S4 keep their CUDA kernels (``csrc/stream_sparse.cu``) and plain
versions, ``stream_sparse_decode_plain`` (the reference's M1 through
``unpack_and_score_plain``) and ``sparse_combine_plain`` (the reference's
scan, line for line); the engines no longer launch them.  Kernels, plain
versions and reference agree bit for bit, pad ids included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.batchkeys import group_positions
from .stream_kernel import WINDOW, check_tables, check_tensors, unpack_and_score_plain
from .topk import _pack, select_keys

__all__ = [
    "doc_ordered",
    "ordinal_offsets",
    "merge_plan",
    "segment_offsets",
    "sparse_combine",
    "sparse_combine_plain",
    "sparse_lanes_topk",
    "stream_sparse_decode",
    "stream_sparse_decode_plain",
    "stream_sparse_topk",
    "stream_sparse_topk_plain",
]

# Number of CUDA kernel launches of S3, of S4 and of SP-stream; chip_smoke.py
# reads them to show the main path went through the kernels.
DECODE_LAUNCHES = 0
COMBINE_LAUNCHES = 0
MERGE_LAUNCHES = 0

# The scan's depth bound (csrc/stream_sparse.cu keeps its partial sums in a
# register stack of this depth).
MAX_SEG_STEPS = 30

# The parts a row is cut into at most (a block's plan entry in
# csrc/sparse_merge.cuh holds its part and the row's parts in 6 bits each).
MAX_BLOCKS = 64


def segment_offsets(cnt, qidx, sub, n_q: int) -> np.ndarray:
    """Each row's segment offsets for the sparse kernels: ``[len(sub), S+1]``
    int32, row r's segment s (the s-th term occurrence of query sub[r])
    holding its window row's windows ``[off[r, s], off[r, s+1])``; S is the
    most segments of a row, rows with fewer repeat their last offset.
    ``cnt`` holds each (query, term occurrence)'s window count and ``qidx``
    its query, ascending, as the planning lists them."""
    cnt = np.asarray(cnt, dtype=np.int64)
    qidx = np.asarray(qidx, dtype=np.int64)
    sub = np.asarray(sub, dtype=np.int64)
    n_t = np.bincount(qidx, minlength=n_q).astype(np.int64)
    t_start = np.concatenate(([0], np.cumsum(n_t)))
    rows = n_t[sub]
    n_s = int(rows.max(initial=0))
    mat = np.zeros((sub.size, n_s), dtype=np.int64)
    if n_s:
        pos = group_positions(rows)
        mat[np.repeat(np.arange(sub.size), rows), pos] = cnt[np.repeat(t_start[sub], rows) + pos]
    off = np.zeros((sub.size, n_s + 1), dtype=np.int32)
    off[:, 1:] = np.cumsum(mat, axis=1)
    return off


def ordinal_offsets(win_ord) -> np.ndarray:
    """``segment_offsets`` of a ``[q, P]`` matrix of window term ordinals
    (each row's ordinals non-decreasing from 0, pads -1 last), as the exact
    engine's planning lays them out."""
    win_ord = np.asarray(win_ord, dtype=np.int64)
    q = win_ord.shape[0]
    n_s = int(win_ord.max(initial=-1)) + 1
    live = win_ord >= 0
    rows = np.broadcast_to(np.arange(q, dtype=np.int64)[:, None], win_ord.shape)
    cnt = np.bincount((rows * n_s + win_ord)[live], minlength=q * n_s).reshape(q, n_s)
    off = np.zeros((q, n_s + 1), dtype=np.int32)
    off[:, 1:] = np.cumsum(cnt, axis=1)
    return off


def doc_ordered(wsrc, cnt) -> np.ndarray:
    """``wsrc`` (window ids in consecutive segments of ``cnt`` windows each,
    a segment a subset of one term's windows) with each segment's ids
    ascending, which is doc order: MaxScore's impact-ordered prefixes made
    into the sparse kernels' segments."""
    wsrc = np.asarray(wsrc, dtype=np.int64)
    seg = np.repeat(np.arange(len(cnt), dtype=np.int64), np.asarray(cnt, dtype=np.int64))
    return np.sort((seg << 32) | wsrc) & 0xFFFFFFFF


def merge_plan(n_win, kk: int, n_sm: int, least: int = 8192) -> np.ndarray:
    """The sparse kernels' blocks: each row's doc axis cut into parts of
    about as many windows (``n_win[q]`` the row's windows in segments),
    enough parts over all rows for about three waves of two blocks an SM,
    each part holding at least max(least, 4 kk) lanes, at most
    ``MAX_BLOCKS`` a row.  Returns int32 ``row << 12 | part << 6 | (parts
    - 1)`` a block, rows in order."""
    lanes = np.asarray(n_win, dtype=np.int64) * WINDOW
    per = max(least, 4 * kk, -(-int(lanes.sum()) // (6 * n_sm)))
    parts = np.clip(-(-lanes // per), 1, MAX_BLOCKS)
    row = np.repeat(np.arange(lanes.size, dtype=np.int64), parts)
    part = np.arange(row.size, dtype=np.int64) - np.repeat(np.cumsum(parts) - parts, parts)
    return ((row << 12) | (part << 6) | (parts[row] - 1)).astype(np.int32)


def check_segments(seg_off, q: int, p: int):
    """Checks ``seg_off`` against a ``[q, p]`` window matrix: a host (CPU)
    int32 ``[q, S+1]`` tensor."""
    if not isinstance(seg_off, torch.Tensor) or seg_off.device.type != "cpu":
        raise ValueError("seg_off must be a CPU tensor (the host planning's)")
    if seg_off.dtype != torch.int32 or seg_off.dim() != 2:
        raise TypeError(f"seg_off must be 2-D int32, got {seg_off.dtype} {tuple(seg_off.shape)}")
    if seg_off.shape[0] != q or seg_off.shape[1] < 1:
        raise ValueError(f"seg_off {tuple(seg_off.shape)} must be [{q}, S + 1]")


def merge_launch(lib_fn, tables, seg_off, q: int, p: int, k: int, n_docs: int,
                 seg_steps: int, extra=()):
    """One launch of SP-stream or SP-exact (``lib_fn``, the library entry
    taking ``tables``' pointers, then ``extra`` ints after n_docs): the
    segments and the block plan go to the card in one copy.  Returns
    (scores [q, k] f32, ids [q, k] int32)."""
    from ._build import library

    dev = tables[0].device
    kk = min(k, p * WINDOW)
    n_s = seg_off.shape[1] - 1
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_s, out_i
    off = seg_off.numpy()
    plan = merge_plan(
        np.clip(off[:, -1], 0, p), kk, torch.cuda.get_device_properties(dev).multi_processor_count
    )
    host = torch.from_numpy(np.concatenate([off.ravel(), plan]))
    both = host.to(dev)
    scratch = torch.empty(
        library().bm25_sparse_merge_scratch(q, plan.size, n_s, kk), dtype=torch.uint8, device=dev
    )
    with torch.cuda.device(dev):
        err = lib_fn(
            *(x.data_ptr() for x in tables), both.data_ptr(), both[off.size:].data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), scratch.data_ptr(), q, p, n_s, plan.size,
            n_docs, *extra, k, kk, seg_steps, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sparse merge kernel launch failed: cudaError {err}")
    return out_s, out_i


def stream_sparse_decode_plain(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs: int):
    """Plain PyTorch version of ``stream_sparse_decode``."""
    q, p = wsrc.shape
    ws = wsrc.long()
    doc, sc = unpack_and_score_plain(
        words, s1_eff, w_off[ws], w_base[ws], w_meta[ws], w_s0[ws], n_docs
    )
    return doc.reshape(q, p * WINDOW), sc.reshape(q, p * WINDOW)


def stream_sparse_decode(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs: int):
    """Decode and score every lane of a ``[Q, P]`` window-id matrix.

    Tables as ``stream_dense_accumulate`` takes them; wsrc [Q, P] int32
    (pad: the zero-length window W).  Returns (doc [Q, P*128] int32, sc
    [Q, P*128] f32): live lanes their doc and ``(tf*s0)/(tf + s1_eff[doc])``,
    dead lanes ``n_docs`` and the same expression at tf = 1 (0.0, since
    ``s1_eff[n_docs]`` is +inf).  A CUDA tensor launches S3 or raises; a CPU
    tensor runs the plain version."""
    global DECODE_LAUNCHES

    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, ((wsrc, torch.int32, "wsrc", 2),))
    if words.device.type == "cpu":
        return stream_sparse_decode_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    q, p = wsrc.shape
    if q * p >= (1 << 31) // WINDOW:
        raise ValueError(f"{q * p} windows exceed the kernel's int32 lane index")

    from ._build import library

    lib = library()
    dev = words.device
    doc = torch.empty((q, p * WINDOW), dtype=torch.int32, device=dev)
    sc = torch.empty((q, p * WINDOW), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bm25_stream_sparse_decode(
            words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
            w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
            wsrc.data_ptr(), doc.data_ptr(), sc.data_ptr(), q * p, n_docs,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_sparse_decode kernel launch failed: cudaError {err}")
    DECODE_LAUNCHES += 1
    return doc, sc


def sparse_combine_plain(df, sf, n_docs: int, seg_steps: int):
    """Plain PyTorch version of ``sparse_combine``: the reference's scan
    (``search/stream.py:339-353``), then ``_pack``."""
    q = df.shape[0]
    s = sf
    for i in range(seg_steps):
        sh = 1 << i
        zero_i = torch.zeros((q, sh), dtype=df.dtype, device=df.device)
        zero_f = torch.zeros((q, sh), dtype=s.dtype, device=s.device)
        same = torch.cat([zero_i == 1, df[:, sh:] == df[:, :-sh]], dim=1)
        add = torch.cat([zero_f, s[:, :-sh]], dim=1)
        s = s + torch.where(same, add, 0.0)
    is_last = torch.cat(
        [df[:, :-1] != df[:, 1:], torch.ones((q, 1), dtype=torch.bool, device=df.device)],
        dim=1,
    )
    cand = torch.where(is_last & (df < n_docs) & (s > 0.0), s, float("-inf"))
    return _pack(cand, df)


def sparse_combine(df, sf, n_docs: int, seg_steps: int):
    """Packed selection keys of doc-sorted lanes.

    df [Q, L] int32, each row ascending (a stable sort of
    ``stream_sparse_decode``'s docs), sf [Q, L] f32 their scores; seg_steps
    >= bit_length(longest run - 1).  Returns keys [Q, L] int64: at the last
    lane of each run with doc < n_docs and run sum > 0 the ``_pack`` key of
    (sum, doc), elsewhere the pad key of (-inf, doc).  A CUDA tensor
    launches S4 or raises; a CPU tensor runs the plain version."""
    global COMBINE_LAUNCHES

    check_tensors(df, ((df, torch.int32, "df", 2), (sf, torch.float32, "sf", 2)))
    if df.shape != sf.shape or df.shape[1] < 1:
        raise ValueError(f"df {tuple(df.shape)} and sf {tuple(sf.shape)} must match, L >= 1")
    if not 0 <= seg_steps <= MAX_SEG_STEPS:
        raise ValueError(f"seg_steps must be in [0, {MAX_SEG_STEPS}], got {seg_steps}")
    if df.device.type == "cpu":
        return sparse_combine_plain(df, sf, n_docs, seg_steps)
    if df.device.type != "cuda":
        raise ValueError(f"unsupported device {df.device}")

    from ._build import library

    lib = library()
    q, lanes = df.shape
    keys = torch.empty((q, lanes), dtype=torch.int64, device=df.device)
    with torch.cuda.device(df.device):
        err = lib.bm25_sparse_combine(
            df.data_ptr(), sf.data_ptr(), keys.data_ptr(), q * lanes, lanes,
            n_docs, seg_steps, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sparse_combine kernel launch failed: cudaError {err}")
    COMBINE_LAUNCHES += 1
    return keys


def _lanes_topk(doc, sc, k: int, n_docs: int, seg_steps: int, combine):
    df, perm = torch.sort(doc, dim=1, stable=True)
    sf = sc.gather(1, perm)
    del perm
    keys = combine(df, sf, n_docs, seg_steps)
    del df, sf
    kk = min(k, keys.shape[1])
    scores, ids = select_keys(keys, kk)
    del keys
    if kk < k:
        pad = k - kk
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=0)
    return scores, ids


def sparse_lanes_topk(doc, sc, k: int, n_docs: int, seg_steps: int):
    """(scores [Q, k] f32 desc, ids [Q, k] int32) of each row's run sums
    over its ``[Q, L]`` (doc, score) lanes, dead lanes ``(n_docs, 0.0)``:
    the stable sort by doc, S4 and the selection.  Rows with fewer than k
    candidates pad with -inf, whose ids follow the reference's ``lax.top_k``
    over the sorted row (the docs of the row's other lanes, lowest first:
    a run's non-last lanes and runs whose sum is not > 0; then ``n_docs``
    for the dead lanes; then 0 past its lanes).  On CUDA lanes this is the
    parent's chain (S4's kernel between torch's sort and selection), which
    SP-stream and SP-exact replace."""
    return _lanes_topk(doc, sc, k, n_docs, seg_steps, sparse_combine)


def stream_sparse_topk_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, k: int, n_docs: int,
    seg_steps: int, seg_off=None,
):
    """Plain PyTorch version of ``stream_sparse_topk`` (S3's and S4's plain
    versions, torch's sort and selection); seg_off is not needed."""
    doc, sc = stream_sparse_decode_plain(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs)
    return _lanes_topk(doc, sc, k, n_docs, seg_steps, sparse_combine_plain)


def stream_sparse_topk(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, k: int, n_docs: int,
    seg_steps: int, seg_off,
):
    """The reference's ``_stream_sparse``: (scores [Q, k] f32 desc, ids
    [Q, k] int32), ties to the lower doc, pads as ``sparse_lanes_topk``
    documents them.  Tables as ``stream_dense_accumulate`` takes them; wsrc
    [Q, P] int32 window ids (pad: the zero-length window W); seg_steps >=
    bit_length(most segments a row - 1).  seg_off [Q, S+1] int32 on the
    host (``segment_offsets``): row q's segment s is its windows ``[seg_off[q,
    s], seg_off[q, s+1])``, doc-ascending, in term order, one a (query,
    term occurrence); windows past ``seg_off[q, S]`` are pads.  A CUDA
    tensor makes one launch of SP-stream or raises; a CPU tensor runs the
    plain version, ``stream_sparse_topk_plain``."""
    global MERGE_LAUNCHES

    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, ((wsrc, torch.int32, "wsrc", 2),))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0 <= seg_steps <= MAX_SEG_STEPS:
        raise ValueError(f"seg_steps must be in [0, {MAX_SEG_STEPS}], got {seg_steps}")
    q, p = wsrc.shape
    check_segments(seg_off, q, p)
    if words.device.type == "cpu":
        return stream_sparse_topk_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, k, n_docs, seg_steps
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")

    from ._build import library

    out = merge_launch(
        library().bm25_stream_sparse_merge, (words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc),
        seg_off, q, p, k, n_docs, seg_steps,
    )
    MERGE_LAUNCHES += 1
    return out
