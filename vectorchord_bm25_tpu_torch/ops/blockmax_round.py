"""The Block-Max round outside the scoring kernel (B1).

The reference runs its whole pruning loop as one device program
(``vectorchord_bm25_tpu/search/blockmax.py::_blockmax_kernel``); its Pallas
kernel is only the scoring step in the middle of a round.  The three
functions here are the rest of it, each a CUDA kernel of
``csrc/blockmax_round.cu`` on a CUDA tensor and a plain PyTorch version on a
CPU tensor:

- ``range_bounds`` (B1-bounds, reference ``:82-107``): every query's dense
  ``[R]`` row of per-range upper bounds, ``(sum_t tr_ub) * (1 + (T+2) *
  1.2e-7)``, each range's terms added in ascending t.
- ``round_select`` (B1-select, ``:114-150``): the round's threshold, the C
  highest bounds of each row with ties to the lower range (``lax.top_k``'s
  rule, which ``torch.topk`` does not promise), those set to -inf in place,
  ``cand_ok = bound > threshold``, each (term, candidate)'s posting span by
  binary search, and one flag: is any query still active?
- ``round_merge`` (B1-merge, ``:194-215``): ``(acc * live) * filter``, the
  score > 0 and doc < N rule, and the lexicographic merge of the ``C * RS``
  candidates into the running top-k, in place.

One deliberate difference from the reference, which no result depends on: a
query whose row maximum is not above its threshold (inactive) keeps its row
as it is and reports ``cand_r = 0``; the reference takes and masks its
candidates too, but all of them fail ``cand_ok``, and a threshold only
rises, so that state is never read again.  The plain versions do the same,
so kernel and plain agree on every output.

``term_windows`` and ``locate`` are the reference's ``[Q, T, lmax]`` window
tables and its searchsorted over them: the plain versions are built from
them, and the exhaustive range sweep (``search/blockmax.py``) uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import lex_topk

__all__ = [
    "locate",
    "range_bounds",
    "range_bounds_plain",
    "round_merge",
    "round_merge_plain",
    "round_select",
    "round_select_plain",
    "term_windows",
]

# Kernel launches since import (or since a caller reset them), one count a
# kernel.  chip_smoke.py reads them to show the main path went through.
BOUNDS_LAUNCHES = 0
SELECT_LAUNCHES = 0
MERGE_LAUNCHES = 0

_INT_MAX = int(np.iinfo(np.int32).max)
_NEG_INF = float("-inf")

# round_merge's key buffer for k > 32 (k <= 32 keeps the top-k in
# registers and ignores it): at least this many u64 keys (32 KB of shared
# memory), and in shared memory up to kMaxDynamicSmem of blockmax_round.cu.
_MERGE_MIN_KEYS = 4096
_MERGE_SMEM_KEYS = 224 * 1024 // 8


def term_windows(tr_range, tr_start, tr_ub, token_tr_start, q_tid, lmax):
    """Each query term's (range, span start, span length, ub) window from
    the CSR, ``[Q, T, lmax]`` each, ranges ascending with INT_MAX pads.
    ``tr_start`` or ``tr_ub`` may be None; its tables are then None."""
    m_pad = tr_range.shape[0] - 1  # index of the pad slot
    tid = q_tid.long()
    base = token_tr_start[tid]  # [Q, T]
    count = token_tr_start[tid + 1] - base
    l_iota = torch.arange(lmax, dtype=torch.int32, device=q_tid.device)
    widx = (base[..., None] + l_iota).clamp_max(m_pad).long()  # [Q, T, L]
    lmask = l_iota < count[..., None]
    qt_range = torch.where(lmask, tr_range[widx], _INT_MAX)  # ascending
    qt_start = qt_len = qt_ub = None
    if tr_start is not None:
        qt_start = torch.where(lmask, tr_start[widx], 0)
        qt_len = torch.where(lmask, tr_start[widx + 1] - tr_start[widx], 0)
    if tr_ub is not None:
        qt_ub = torch.where(lmask, tr_ub[widx], 0.0)
    return qt_range, qt_start, qt_len, qt_ub


def locate(qt_range, qt_start, qt_len, cand_r, lmax, cand_ok=None):
    """Each (query term, candidate range) posting span: (start, length)
    ``[Q, T, C]``, length 0 where the term has no postings in the range
    or the candidate is not ``cand_ok``."""
    q, t, _ = qt_range.shape
    cand_qt = cand_r[:, None, :].expand(q, t, cand_r.shape[1]).contiguous()
    idx = torch.searchsorted(qt_range, cand_qt).clamp_max(lmax - 1)
    found = qt_range.gather(2, idx) == cand_qt
    if cand_ok is not None:
        found &= cand_ok[:, None, :]
    start = torch.where(found, qt_start.gather(2, idx), 0)
    length = torch.where(found, qt_len.gather(2, idx), 0)
    return start, length


def _check(pairs, device):
    for x, dtype, ndim, name in pairs:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dimensions, got {x.dim()}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device_kind(device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type


def _launch(fn, name, device, *args):
    """Call one C entry point on ``device``'s current stream; raises on a
    refused launch.  Switches the current device only where ``device`` is
    another one."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# B1-bounds


def _bounds_scale(n_terms: int) -> float:
    """The reference's float-safety scale for a T-term f32 accumulation,
    rounded to f32 as ``np.float32(1.0 + (t + 2) * 1.2e-7)`` is."""
    return float(np.float32(1.0 + (n_terms + 2) * 1.2e-7))


def range_bounds_plain(token_tr_start, tr_range, tr_ub, q_tid, *, n_ranges, lmax):
    """Plain PyTorch version of ``range_bounds``: one ``scatter_add_`` a
    term, so each range sums its terms in ascending t."""
    q, t = q_tid.shape
    qt_range, _, _, qt_ub = term_windows(
        tr_range, None, tr_ub, token_tr_start, q_tid, lmax
    )
    safe_r = torch.where(qt_range == _INT_MAX, n_ranges, qt_range).long()
    ub_work = torch.zeros((q, n_ranges + 1), dtype=torch.float32, device=q_tid.device)
    for ti in range(t):
        ub_work.scatter_add_(1, safe_r[:, ti], qt_ub[:, ti])
    scale = torch.tensor(_bounds_scale(t), dtype=torch.float32, device=q_tid.device)
    return (ub_work[:, :n_ranges] * scale).contiguous()


def range_bounds(token_tr_start, tr_range, tr_ub, q_tid, *, n_ranges: int, lmax: int):
    """``[Q, R]`` float32 upper bounds of every (query, range).

    token_tr_start [V+2] i32 CSR over the (term, range) groups (entry V+1
    repeats V: the null term's empty span), tr_range [M+1] i32 ascending
    inside a term, tr_ub [M+1] f32 (>= 0), q_tid [Q, T] i32 (pad = V).
    ``lmax`` (at least the longest term's group count) sizes the plain
    version's windows; the kernel walks the CSR spans themselves.  A CUDA
    tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    global BOUNDS_LAUNCHES

    dev = q_tid.device
    _check(
        (
            (token_tr_start, torch.int32, 1, "token_tr_start"),
            (tr_range, torch.int32, 1, "tr_range"),
            (tr_ub, torch.float32, 1, "tr_ub"),
            (q_tid, torch.int32, 2, "q_tid"),
        ),
        dev,
    )
    if _device_kind(dev) == "cpu":
        return range_bounds_plain(
            token_tr_start, tr_range, tr_ub, q_tid, n_ranges=n_ranges, lmax=lmax
        )

    from ._build import library

    lib = library()
    q, t = q_tid.shape
    ub_work = torch.empty((q, n_ranges), dtype=torch.float32, device=dev)
    if q * n_ranges == 0:
        return ub_work
    _launch(
        lib.bm25_range_bounds, "range_bounds", dev,
        token_tr_start.data_ptr(), tr_range.data_ptr(), tr_ub.data_ptr(),
        q_tid.data_ptr(), ub_work.data_ptr(), q, t, n_ranges, _bounds_scale(t),
    )
    BOUNDS_LAUNCHES += 1
    return ub_work


# ---------------------------------------------------------------------------
# B1-select


def _select_outputs(q, t, chunk, device, flag):
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=device)
    elif flag.dtype != torch.int32 or flag.numel() != 1 or flag.device != device:
        raise ValueError("flag must be one zeroed int32 on the inputs' device")
    cand_r = torch.empty((q, chunk), dtype=torch.int32, device=device)
    start = torch.empty((q, t, chunk), dtype=torch.int32, device=device)
    length = torch.empty((q, t, chunk), dtype=torch.int32, device=device)
    return cand_r, start, length, flag


def round_select_plain(
    ub_work, topk_s, tr_range, tr_start, token_tr_start, q_tid, *,
    chunk, lmax, flag=None,
):
    """Plain PyTorch version of ``round_select``.  The top-C is a stable
    descending sort's head: equal bounds keep their index order, so ties go
    to the lower range and a row short of live bounds refills with its
    lowest -inf ranges, as ``lax.top_k`` does."""
    q, t = q_tid.shape
    cand_r, start, length, flag = _select_outputs(q, t, chunk, q_tid.device, flag)
    if q * chunk == 0:
        return cand_r, start, length, flag
    thresh = topk_s[:, -1].clamp_min(0.0)  # score > 0 rule: starts at 0
    active = ub_work.amax(dim=1) > thresh
    order = torch.sort(ub_work, dim=1, descending=True, stable=True)
    cand_ub, picked = order.values[:, :chunk], order.indices[:, :chunk]
    masked = ub_work.scatter(1, picked, _NEG_INF)
    ub_work.copy_(torch.where(active[:, None], masked, ub_work))
    # Refilled already-processed (-inf) ranges and ranges at or below the
    # threshold must not be rescored.
    cand_ok = (cand_ub > thresh[:, None]) & active[:, None]
    cand_r.copy_(torch.where(active[:, None], picked, 0))
    qt_range, qt_start, qt_len, _ = term_windows(
        tr_range, tr_start, None, token_tr_start, q_tid, lmax
    )
    s, ln = locate(qt_range, qt_start, qt_len, cand_r, lmax, cand_ok)
    start.copy_(s)
    length.copy_(ln)
    flag.copy_(active.any().reshape(1))
    return cand_r, start, length, flag


def round_select(
    ub_work, topk_s, tr_range, tr_start, token_tr_start, q_tid, *,
    chunk: int, lmax: int, flag=None,
):
    """One round's candidates: ``(cand_r [Q, C] i32, start [Q, T, C] i32,
    length [Q, T, C] i32, flag [1] i32)``.

    ub_work [Q, R] f32 bounds (>= +0, or -inf once taken), updated in
    place: an active query's C candidates become -inf.  topk_s [Q, k] f32
    is the running top-k, descending with -inf pads; the threshold is
    ``max(topk_s[:, k-1], 0)``.  A query is active while its row maximum is
    above its threshold.  ``cand_r`` holds an active query's C highest
    bounds' ranges (descending bound, ties to the lower range), 0 for an
    inactive one; ``length`` is 0 where the candidate's bound is not above
    the threshold or the term has no postings in the range.  ``flag`` (one
    zeroed int32, allocated if not given) becomes 1 if any query is active:
    the one value the host loop reads a round.  ``1 <= chunk <= R``.  A
    CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    global SELECT_LAUNCHES

    dev = q_tid.device
    _check(
        (
            (ub_work, torch.float32, 2, "ub_work"),
            (topk_s, torch.float32, 2, "topk_s"),
            (tr_range, torch.int32, 1, "tr_range"),
            (tr_start, torch.int32, 1, "tr_start"),
            (token_tr_start, torch.int32, 1, "token_tr_start"),
            (q_tid, torch.int32, 2, "q_tid"),
        ),
        dev,
    )
    q, t = q_tid.shape
    r = ub_work.shape[1]
    if ub_work.shape[0] != q or topk_s.shape[0] != q or topk_s.shape[1] < 1:
        raise ValueError("ub_work must be [Q, R] and topk_s [Q, k >= 1]")
    if q and not 1 <= chunk <= r:
        raise ValueError(f"chunk must be in [1, {r}], got {chunk}")
    if _device_kind(dev) == "cpu":
        return round_select_plain(
            ub_work, topk_s, tr_range, tr_start, token_tr_start, q_tid,
            chunk=chunk, lmax=lmax, flag=flag,
        )

    from ._build import library

    lib = library()
    cand_r, start, length, flag = _select_outputs(q, t, chunk, dev, flag)
    if q == 0:
        return cand_r, start, length, flag
    # The kernel keeps its C keys here where they do not fit its shared
    # memory beside the row.
    scratch = torch.empty((q, chunk), dtype=torch.int64, device=dev)
    _launch(
        lib.bm25_round_select, "round_select", dev,
        ub_work.data_ptr(), topk_s.data_ptr(), tr_range.data_ptr(),
        tr_start.data_ptr(), token_tr_start.data_ptr(), q_tid.data_ptr(),
        cand_r.data_ptr(), start.data_ptr(), length.data_ptr(), flag.data_ptr(),
        scratch.data_ptr(), q, t, r, chunk, topk_s.shape[1],
    )
    SELECT_LAUNCHES += 1
    return cand_r, start, length, flag


# ---------------------------------------------------------------------------
# B1-merge


def round_merge_plain(acc, cand_r, doc_live, filter_mask, topk_s, topk_d, *, n_docs):
    """Plain PyTorch version of ``round_merge``: the reference's mask and
    ``lex_topk`` over the running top-k and the candidates."""
    q, c, rs = acc.shape
    k = topk_s.shape[1]
    rs_iota = torch.arange(rs, dtype=torch.int32, device=acc.device)
    # Deleted/filtered docs are masked on the accumulated per-doc scores
    # (the factors are per-doc, so they distribute over terms).
    cand_docs = cand_r[:, :, None] * rs + rs_iota  # [Q, C, RS]
    cand_docs_c = cand_docs.clamp_max(n_docs).long()
    masked = acc * doc_live[cand_docs_c] * filter_mask[cand_docs_c]
    flat_s = masked.reshape(q, c * rs)
    flat_d = cand_docs.reshape(q, c * rs)
    ok = (flat_s > 0.0) & (flat_d < n_docs)
    flat_s = torch.where(ok, flat_s, _NEG_INF)
    flat_d = torch.where(ok, flat_d, _INT_MAX)
    new_s, new_d = lex_topk(
        torch.cat([topk_s, flat_s], dim=1), torch.cat([topk_d, flat_d], dim=1), k
    )
    topk_s.copy_(new_s)
    topk_d.copy_(new_d)
    return topk_s, topk_d


def round_merge(acc, cand_r, doc_live, filter_mask, topk_s, topk_d, *, n_docs: int):
    """Merge one round's scores into the running top-k, in place; returns
    ``(topk_s, topk_d)``.

    acc [Q, C, RS] f32 (the scoring kernel's output), cand_r [Q, C] i32,
    doc_live and filter_mask [N+1] f32, topk_s [Q, k] f32 and topk_d [Q, k]
    i32 as a previous merge left them (score descending, doc ascending at
    equal scores, then (-inf, INT_MAX) pads).  Candidate (q, c, slot) is doc
    ``cand_r[q, c] * RS + slot`` and scores ``(acc * live[d]) * filter[d]``
    at ``d = min(doc, N)``; it counts where that is > 0 and doc < N, and no
    such doc may already be in the running top-k (every range is scored in
    one round only).  A CUDA tensor launches the kernel or raises; a CPU
    tensor runs the plain version."""
    global MERGE_LAUNCHES

    dev = acc.device
    _check(
        (
            (acc, torch.float32, 3, "acc"),
            (cand_r, torch.int32, 2, "cand_r"),
            (doc_live, torch.float32, 1, "doc_live"),
            (filter_mask, torch.float32, 1, "filter_mask"),
            (topk_s, torch.float32, 2, "topk_s"),
            (topk_d, torch.int32, 2, "topk_d"),
        ),
        dev,
    )
    q, c, rs = acc.shape
    k = topk_s.shape[1]
    if tuple(cand_r.shape) != (q, c) or topk_s.shape != topk_d.shape or (
        topk_s.shape[0] != q or k < 1
    ):
        raise ValueError("cand_r must be [Q, C]; topk_s and topk_d [Q, k >= 1]")
    if min(doc_live.numel(), filter_mask.numel()) < n_docs + 1:
        raise ValueError(f"doc_live and filter_mask need {n_docs + 1} entries")
    if _device_kind(dev) == "cpu":
        return round_merge_plain(
            acc, cand_r, doc_live, filter_mask, topk_s, topk_d, n_docs=n_docs
        )

    from ._build import library

    lib = library()
    if q == 0:
        return topk_s, topk_d
    buf_keys = max(_MERGE_MIN_KEYS, 1 << (2 * k - 1).bit_length())
    scratch = None
    if buf_keys > _MERGE_SMEM_KEYS:
        scratch = torch.empty((q, buf_keys), dtype=torch.int64, device=dev)
    _launch(
        lib.bm25_round_merge, "round_merge", dev,
        acc.data_ptr(), cand_r.data_ptr(), doc_live.data_ptr(),
        filter_mask.data_ptr(), topk_s.data_ptr(), topk_d.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        q, c, rs, k, n_docs, buf_keys,
    )
    MERGE_LAUNCHES += 1
    return topk_s, topk_d
