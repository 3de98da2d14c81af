"""Exact rescore of MaxScore candidates (counterpart of M4 ``_stream_rescore``).

MaxScore's phase 2 (``search/stream.py:366-431``): for each (query,
candidate doc) and each query term, binary-search the term's doc-ascending
window span for the last window whose base is <= the candidate, decode it,
and add the candidate's posting if it is there; then keep the k best
(score desc, doc asc), as the reference's sort does.

On a CUDA tensor ``rescore_topk`` (S5) makes one launch of
``csrc/stream_rescore.cu``, which scores and selects: no library selection
runs after it.  ``stream_rescore``, the ``[Q, C]`` scores alone, launches
the same kernel with its scores output and no selection.  On a CPU tensor
each runs its plain version: ``stream_rescore_plain``, the reference's
search and decode with the terms added in ascending order, and for
``rescore_topk`` ``lex_topk`` after it.  Kernel and plain versions add in
the same order and agree bit for bit, ids included; the reference's
``jnp.sum`` over the terms has XLA's order, so against it the scores agree
within a few ulps and the ids exactly.

The kernel keeps a query's packed keys in shared memory while
``select_room(C, k)`` keys fit ``SMEM_KEYS``; past that the wrapper hands
it a ``[Q, select_room(C, k)]`` scratch row in device memory instead.  No
C or k is refused.
"""

from __future__ import annotations

import torch

from .stream_kernel import check_tables, check_tensors, unpack_and_score_plain
from .topk import lex_topk

__all__ = [
    "SMEM_KEYS",
    "rescore_topk",
    "rescore_topk_plain",
    "select_room",
    "stream_rescore",
    "stream_rescore_plain",
    "topk_of_scores",
]

# Number of CUDA kernel launches of S5; chip_smoke.py reads it to show the
# main path went through the kernel.
LAUNCHES = 0

# Keys a block of the kernel keeps in shared memory: kMaxDynamicSmem of
# csrc/stream_rescore.cu (208 KB) at 8 B a key.
SMEM_KEYS = 208 * 1024 // 8


def select_room(n_c: int, k: int) -> int:
    """Keys the kernel holds a query for the selection: the C keys and room
    to sort the min(k, C) selected behind them (a power of two), or room to
    sort all C in place when every key is selected; 0 for none.  Mirrors
    ``select_room`` of csrc/stream_rescore.cu."""
    kk = min(k, n_c)
    if kk <= 0:
        return 0
    return (n_c if kk < n_c else 0) + (1 << (kk - 1).bit_length())


def stream_rescore_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs: int
):
    """Plain PyTorch version of ``stream_rescore``."""
    w_pad = w_off.shape[0] - 1
    span = int((t_hi - t_lo).max()) if t_lo.numel() else 0
    steps = max(span, 1).bit_length() + 1
    scores = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for t in range(t_lo.shape[1]):
        lo = t_lo[:, t : t + 1].expand_as(cand)
        l, r = lo, t_hi[:, t : t + 1].expand_as(cand)
        for _ in range(steps):
            m = (l + r) >> 1
            go = (m < r) & (w_base[m.clamp(max=w_pad).long()] <= cand)
            l = torch.where(go, m + 1, l)
            r = torch.where(go, r, m)
        wi = torch.where(l > lo, l - 1, w_pad).long()
        doc, sc = unpack_and_score_plain(
            words, s1_eff, w_off[wi], w_base[wi], w_meta[wi], w_s0[wi], n_docs
        )
        scores = scores + torch.where(doc == cand[..., None], sc, 0.0).sum(-1)
    keep = (cand < n_docs) & (scores > 0.0)
    return torch.where(keep, scores, float("-inf"))


def _check(words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs):
    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, (
        (cand, torch.int32, "cand", 2),
        (t_lo, torch.int32, "t_lo", 2),
        (t_hi, torch.int32, "t_hi", 2),
    ))
    if t_lo.shape != t_hi.shape or t_lo.shape[0] != cand.shape[0]:
        raise ValueError(
            f"t_lo {tuple(t_lo.shape)} and t_hi {tuple(t_hi.shape)} must be "
            f"[Q, T] with cand's Q = {cand.shape[0]}"
        )
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


def _launch(words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k, n_docs):
    """One launch of S5: ([Q, C] scores, None, None) for k = 0, else
    (None, [Q, k] scores, [Q, k] ids)."""
    global LAUNCHES

    from ._build import library

    dev = words.device
    (q, c), t = cand.shape, t_lo.shape[1]
    scores = out_s = out_i = scratch = None
    if k == 0:
        scores = torch.empty((q, c), dtype=torch.float32, device=dev)
    else:
        out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
        room = select_room(c, k)
        if room > SMEM_KEYS:
            scratch = torch.empty((q, room), dtype=torch.int64, device=dev)
    if q == 0 or (k == 0 and c == 0):
        return scores, out_s, out_i
    lib = library()
    with torch.cuda.device(dev):
        err = lib.bm25_stream_rescore_topk(
            words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
            w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
            cand.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (scores, out_s, out_i, scratch)),
            q, c, t, n_docs, k, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_rescore kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return scores, out_s, out_i


def stream_rescore(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs: int
):
    """Exact scores of candidate docs.

    Tables as ``stream_dense_accumulate`` takes them; cand [Q, C] int32 doc
    ids (pad = n_docs); t_lo/t_hi [Q, T] int32 each query term's window span
    in the stream's doc-ascending order (pad terms: an empty span).  Returns
    [Q, C] f32: the sum over the terms, in ascending order, of the
    candidate's postings, or -inf unless the candidate is < n_docs and its
    sum > 0 (deleted and filtered docs score 0 through ``s1_eff``).  A CUDA
    tensor launches S5 (its scores output, no selection) or raises; a CPU
    tensor runs the plain version."""
    _check(words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs)
    if words.device.type == "cpu":
        return stream_rescore_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs
        )
    return _launch(
        words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, 0, n_docs
    )[0]


def topk_of_scores(scores, cand, k: int):
    """The k best (score desc, doc asc) of rescored candidates, as the
    reference's sort leaves them: (scores [Q, k] f32, ids [Q, k] int32),
    -inf slots carrying id 0, padded past C = cand.shape[1]."""
    kk = min(k, cand.shape[1])
    scores, ids = lex_topk(scores, cand, kk)
    ids = torch.where(torch.isfinite(scores), ids, 0)
    if kk < k:
        pad = k - kk
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=0)
    return scores, ids


def rescore_topk_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k: int,
    n_docs: int,
):
    """Plain PyTorch version of ``rescore_topk``: ``stream_rescore_plain``
    then ``lex_topk``."""
    scores = stream_rescore_plain(
        words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs
    )
    return topk_of_scores(scores, cand, k)


def rescore_topk(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k: int,
    n_docs: int,
):
    """The reference's ``_stream_rescore``: (scores [Q, k] f32 desc, ids
    [Q, k] int32), ties to the lower doc; -inf slots carry id 0, and slots
    past C candidates are (-inf, 0).  Inputs as ``stream_rescore``; cand's
    ids lie in [0, n_docs].  A CUDA tensor makes one launch of S5, which
    scores and selects, or raises; a CPU tensor runs the plain version."""
    _check(words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if words.device.type == "cpu":
        return rescore_topk_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k, n_docs
        )
    if k == 0:
        empty = torch.empty((cand.shape[0], 0), device=words.device)
        return empty, empty.int()
    _, out_s, out_i = _launch(
        words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k, n_docs
    )
    return out_s, out_i
