"""The exact engine's gathers and scatters (counterpart of the jitted
``_score_and_topk*`` functions of ``search/exact.py``).

Three kernels, each the part of one reference function that touches every
posting lane; the top-k that follows is ``ops/topk.py`` (dense, compact) or
``ops/stream_sparse.py`` (sparse):

- ``exact_dense_accumulate`` (E1, ``csrc/exact_dense.cu``): the gather of
  masked 128-lane windows of the ``[R+1, 128]`` posting rows (f32 or bf16
  impacts), times ``doc_live[doc]``, scatter-added into a ``[q, N+1]``
  accumulator and times the filter (``_score_and_topk``,
  ``search/exact.py:148-182``);
- ``exact_sparse_gather`` (E2, ``csrc/exact_sparse.cu``): the same gather
  into ``[q, P*128]`` (doc, score) lanes, times live and filter per lane,
  dead lanes ``(n_docs, 0.0)`` (``_score_and_topk_sparse``, ``:217-225``);
  ``exact_sparse_topk``'s plain version adds the stable sort, S4 and the
  selection, while on a CUDA tensor it is one launch of SP-exact
  (``csrc/exact_merge.cu`` on ``csrc/sparse_merge.cuh``), which gathers,
  merges each row's segments and selects without writing a lane; the engine
  no longer launches E2;
- ``exact_compact_accumulate`` (E3, ``csrc/exact_compact.cu``): the range
  index's 5 B/posting streams read as (term, range) groups and
  scatter-added into ``[q, N+1]`` (``_score_and_topk_compact``, ``:95-145``).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
PyTorch version beside it, which the CPU tests hold against the reference.

Exactness.  The reference's scatter-add adds each (query, doc)'s terms in
window order, which is term order inside a query.  E1 and E3 take each
window's term ordinal and launch once, on the planning's layout (each
row's ordinals in non-decreasing runs, pads last; first docs rising
inside an ordinal for E1, ranges for E3): E1's blocks own one query's doc
tile in shared memory and write it once, the filter applied in the write
(``csrc/dense_tiles.cuh``, no zero-fill before it), and E3's own one
query's slice of the doc axis in the accumulator; both walk the ordinals
in ascending order, and a row off the layout is served in the
reference's order by one thread.  Inside one ordinal a (query, doc) is
hit at most once, since a term's postings are unique per doc, so the adds
land in the reference's order with no atomics.  Kernels, plain versions
and reference agree bit for bit.
"""

from __future__ import annotations

import torch

from . import dense_tiles
from .dense_tiles import PAD, lists_in_layout
from .stream_kernel import check_tensors
from .stream_sparse import (
    MAX_SEG_STEPS,
    _lanes_topk,
    check_segments,
    merge_launch,
    sparse_combine_plain,
)
from .topk import new_accumulator

__all__ = [
    "compact_rows_in_layout",
    "compact_scatter",
    "dense_rows_in_layout",
    "exact_compact_accumulate",
    "exact_compact_accumulate_plain",
    "exact_dense_accumulate",
    "exact_dense_accumulate_plain",
    "exact_sparse_gather",
    "exact_sparse_gather_plain",
    "exact_sparse_topk",
    "exact_sparse_topk_plain",
]

# CUDA kernel launches: E1 on f32 and on bf16 rows, E2, E3 and SP-exact (one
# a dispatch each).  chip_smoke.py reads them to show the main path went
# through the kernels.
DENSE_LAUNCHES = 0
DENSE_BF16_LAUNCHES = 0
SPARSE_LAUNCHES = 0
COMPACT_LAUNCHES = 0
MERGE_LAUNCHES = 0

ROW = 128  # lanes per posting row (index/sealed.py BLOCK)
_IMPACT = (torch.float32, torch.bfloat16)
_INT_MAX = (1 << 31) - 1


def _check_ordinals(ords, like, n_ord, name):
    check_tensors(like, ((ords, torch.int32, name, 2),))
    if ords.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(ords.shape)}, need {tuple(like.shape)}")
    if n_ord < 0:
        raise ValueError(f"n_ord must be >= 0, got {n_ord}")


def _flat_rows(acc):
    """The accumulator's padded rows as one flat tensor, and the row stride."""
    stride = acc.stride(0)
    return acc.as_strided((acc.shape[0] * stride,), (1,)), stride


def _check_rows(post_docid, post_impact, doc_live, n_docs, wins):
    if post_impact.dtype not in _IMPACT:
        raise TypeError(f"post_impact must be float32 or bfloat16, got {post_impact.dtype}")
    check_tensors(post_docid, (
        (post_docid, torch.int32, "post_docid", 2),
        (post_impact, post_impact.dtype, "post_impact", 2),
        (doc_live, torch.float32, "doc_live", 1),
        *((w, torch.int32, name, 2) for name, w in wins),
    ))
    if post_docid.shape[1] != ROW or post_impact.shape != post_docid.shape:
        raise ValueError("post_docid and post_impact must both be [R+1, 128]")
    if doc_live.numel() != n_docs + 1:
        raise ValueError(f"doc_live has {doc_live.numel()} entries, need {n_docs + 1}")
    shapes = {tuple(w.shape) for _, w in wins}
    if len(shapes) != 1 or min(shapes.pop()) < 1:
        raise ValueError("win_row, win_lo and win_hi must share one [q, P] shape, q, P >= 1")


def _check_filter(post_docid, filter_mask, n_docs):
    check_tensors(post_docid, ((filter_mask, torch.float32, "filter_mask", 1),))
    if filter_mask.numel() != n_docs + 1:
        raise ValueError(f"filter_mask has {filter_mask.numel()} entries, need {n_docs + 1}")


def _gather_rows(post_docid, post_impact, doc_live, rows, lo, hi):
    """The reference's masked gather of posting rows: (d, sc) with ``sc =
    where(valid, impact, 0) * doc_live[d]`` for every lane."""
    lane = torch.arange(ROW, dtype=torch.int32, device=rows.device)
    r = rows.long()
    d = post_docid[r]  # [..., 128]
    valid = (lane >= lo[..., None]) & (lane < hi[..., None])
    sc = torch.where(valid, post_impact[r].float(), 0.0) * doc_live[d.long()]
    return d, valid, sc


def exact_dense_accumulate_plain(
    post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord,
    n_ord: int, n_docs: int, filter_mask=None,
):
    """Plain PyTorch version of ``exact_dense_accumulate``: per term ordinal
    in ascending order, the reference's gather of that ordinal's windows,
    every lane added into the accumulator (lanes outside a window add 0.0),
    then the filter multiplied into the sums."""
    q, p = win_row.shape
    acc = new_accumulator(q, n_docs, win_row.device)
    flat, stride = _flat_rows(acc)
    rows, lo, hi = win_row.reshape(-1), win_lo.reshape(-1), win_hi.reshape(-1)
    ords = win_ord.reshape(-1)
    for o in range(n_ord):
        sel = torch.nonzero(ords == o).squeeze(1)
        if sel.numel() == 0:
            continue
        d, _, sc = _gather_rows(post_docid, post_impact, doc_live, rows[sel], lo[sel], hi[sel])
        idx = (sel // p)[:, None] * stride + d.long()
        flat.index_add_(0, idx.reshape(-1), sc.reshape(-1))
    if filter_mask is not None:
        acc.mul_(filter_mask)  # the same product as acc * filter[None, :]
    return acc


def dense_rows_in_layout(post_docid, win_row, win_lo, win_hi, win_ord, n_ord: int):
    """[q] bool: whether each row of a window matrix keeps the layout E1's
    tile walk relies on (``ops/dense_tiles.py``): the windows with an
    ordinal in [0, n_ord) first, in non-decreasing ordinal order, pads
    after them, each of them a row in range with lanes ``0 <= lo < hi <=
    128``, and inside one ordinal first docs ``post_docid[row, lo]``
    strictly rising.  The kernel serves any other row one lane at a time,
    in the reference's order."""
    q, p = win_row.shape
    o, r = win_ord.reshape(-1), win_row.reshape(-1).long()
    lo, hi = win_lo.reshape(-1).long(), win_hi.reshape(-1).long()
    real = (o >= 0) & (o < n_ord)
    bad = (r < 0) | (r >= post_docid.shape[0]) | (lo < 0) | (lo >= hi) | (hi > ROW)
    cell = torch.where(real & ~bad, r * ROW + lo, 0)
    first = post_docid.reshape(-1)[cell]
    query = torch.arange(q, device=o.device).repeat_interleave(p)
    return lists_in_layout(torch.where(real, o, PAD), first, bad, query, q)


def exact_dense_accumulate(
    post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord,
    n_ord: int, n_docs: int, filter_mask=None,
):
    """``[q, n_docs + 1]`` f32 accumulator of every window's impacts.

    post_docid [R+1, 128] int32 (pad row R, pad doc N), post_impact [R+1,
    128] f32 or bf16, doc_live [N+1] f32; win_row/win_lo/win_hi [q, P] int32
    posting rows and their live lanes [lo, hi) (pad: row R, lo = hi = 0);
    win_ord [q, P] int32, each window's term ordinal inside its query, -1
    for a pad; n_ord, one more than the largest ordinal; filter_mask [N+1]
    f32 or None, multiplied into the sums (``acc * filter``).  The result
    is a row view of a 16-B-aligned allocation
    (``ops.topk.new_accumulator``).  A CUDA tensor launches the kernel once
    (it writes every cell, the filter applied in the write: the
    accumulator is not zero-filled first) or raises; a CPU tensor runs the
    plain version."""
    global DENSE_LAUNCHES, DENSE_BF16_LAUNCHES

    wins = (("win_row", win_row), ("win_lo", win_lo), ("win_hi", win_hi))
    _check_rows(post_docid, post_impact, doc_live, n_docs, wins)
    _check_ordinals(win_ord, win_row, n_ord, "win_ord")
    if filter_mask is not None:
        _check_filter(post_docid, filter_mask, n_docs)
    args = (
        post_docid, post_impact, doc_live, win_row, win_lo, win_hi, win_ord,
        n_ord, n_docs, filter_mask,
    )
    if post_docid.device.type == "cpu":
        return exact_dense_accumulate_plain(*args)
    if post_docid.device.type != "cuda":
        raise ValueError(f"unsupported device {post_docid.device}")
    q, p = win_row.shape
    if q * p >= 1 << 31:
        raise ValueError(f"{q * p} windows exceed the kernel's int32 window index")

    from ._build import library

    lib = library()
    dev = post_docid.device
    acc = new_accumulator(q, n_docs, dev, zero=False)
    bf16 = post_impact.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        err = lib.bm25_exact_dense_accumulate(
            post_docid.data_ptr(), post_impact.data_ptr(), doc_live.data_ptr(),
            win_row.data_ptr(), win_lo.data_ptr(), win_hi.data_ptr(),
            win_ord.data_ptr(),
            None if filter_mask is None else filter_mask.data_ptr(),
            acc.data_ptr(), q, p, n_ord, acc.stride(0), n_docs,
            post_docid.shape[0], dense_tiles.TILE, int(bf16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"exact_dense_accumulate kernel launch failed: cudaError {err}")
    if bf16:
        DENSE_BF16_LAUNCHES += 1
    else:
        DENSE_LAUNCHES += 1
    return acc


def exact_sparse_gather_plain(
    post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi, n_docs: int
):
    """Plain PyTorch version of ``exact_sparse_gather``, the reference's
    statements (``search/exact.py:217-229``)."""
    q, p = win_row.shape
    d, valid, sc = _gather_rows(post_docid, post_impact, doc_live, win_row, win_lo, win_hi)
    sc = sc * filter_mask[d.long()]
    d = torch.where(valid, d, n_docs)  # pads sort last
    return d.reshape(q, p * ROW), sc.reshape(q, p * ROW)


def exact_sparse_gather(
    post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi, n_docs: int
):
    """Every lane of a ``[q, P]`` window matrix as (doc, score).

    Tables and windows as ``exact_dense_accumulate`` takes them; filter_mask
    [N+1] f32 (1 keeps the doc; slot N is 1).  Returns (doc [q, P*128] int32,
    sc [q, P*128] f32): a live lane its doc and ``(impact * doc_live[doc]) *
    filter_mask[doc]`` in f32, a dead lane ``n_docs`` and 0.0.  A CUDA tensor
    launches E2 or raises; a CPU tensor runs the plain version."""
    global SPARSE_LAUNCHES

    wins = (("win_row", win_row), ("win_lo", win_lo), ("win_hi", win_hi))
    _check_rows(post_docid, post_impact, doc_live, n_docs, wins)
    _check_filter(post_docid, filter_mask, n_docs)
    args = (post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi, n_docs)
    if post_docid.device.type == "cpu":
        return exact_sparse_gather_plain(*args)
    if post_docid.device.type != "cuda":
        raise ValueError(f"unsupported device {post_docid.device}")
    q, p = win_row.shape
    if q * p >= (1 << 31) // ROW:
        raise ValueError(f"{q * p} windows exceed the kernel's int32 lane index")

    from ._build import library

    lib = library()
    dev = post_docid.device
    doc = torch.empty((q, p * ROW), dtype=torch.int32, device=dev)
    sc = torch.empty((q, p * ROW), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bm25_exact_sparse_gather(
            post_docid.data_ptr(), post_impact.data_ptr(), doc_live.data_ptr(),
            filter_mask.data_ptr(), win_row.data_ptr(), win_lo.data_ptr(),
            win_hi.data_ptr(), doc.data_ptr(), sc.data_ptr(), q * p, n_docs,
            post_docid.shape[0], int(post_impact.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"exact_sparse_gather kernel launch failed: cudaError {err}")
    SPARSE_LAUNCHES += 1
    return doc, sc


def exact_sparse_topk_plain(
    post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi,
    k: int, n_docs: int, seg_steps: int, seg_off=None,
):
    """Plain PyTorch version of ``exact_sparse_topk``: E2's plain version,
    the stable sort, S4's plain version and the selection (the reference's
    statements, ``search/exact.py:217-254``); seg_off is not needed."""
    doc, sc = exact_sparse_gather_plain(
        post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi, n_docs
    )
    return _lanes_topk(doc, sc, k, n_docs, seg_steps, sparse_combine_plain)


def exact_sparse_topk(
    post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi,
    k: int, n_docs: int, seg_steps: int, seg_off,
):
    """The reference's ``_score_and_topk_sparse``: (scores [q, k] f32 desc,
    ids [q, k] int32), ties to the lower doc, pads as ``sparse_lanes_topk``
    documents them.  Inputs as ``exact_sparse_gather`` takes them; seg_off
    [q, S+1] int32 on the host, each row's segments (``stream_sparse.segment_offsets``:
    a term's windows, doc-ascending, in term order; windows past the last
    offset are pads).  A CUDA tensor makes one launch of SP-exact or raises;
    a CPU tensor runs the plain version, ``exact_sparse_topk_plain``."""
    global MERGE_LAUNCHES

    wins = (("win_row", win_row), ("win_lo", win_lo), ("win_hi", win_hi))
    _check_rows(post_docid, post_impact, doc_live, n_docs, wins)
    _check_filter(post_docid, filter_mask, n_docs)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0 <= seg_steps <= MAX_SEG_STEPS:
        raise ValueError(f"seg_steps must be in [0, {MAX_SEG_STEPS}], got {seg_steps}")
    q, p = win_row.shape
    check_segments(seg_off, q, p)
    if post_docid.device.type == "cpu":
        return exact_sparse_topk_plain(
            post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi,
            k, n_docs, seg_steps,
        )
    if post_docid.device.type != "cuda":
        raise ValueError(f"unsupported device {post_docid.device}")

    from ._build import library

    out = merge_launch(
        library().bm25_exact_sparse_merge,
        (post_docid, post_impact, doc_live, filter_mask, win_row, win_lo, win_hi),
        seg_off, q, p, k, n_docs, seg_steps,
        extra=(post_docid.shape[0], int(post_impact.dtype == torch.bfloat16)),
    )
    MERGE_LAUNCHES += 1
    return out


def _check_compact(post_impact, post_local, tr_range, tr_start, grp_ids, rs):
    if post_impact.dtype not in _IMPACT:
        raise TypeError(f"post_impact must be float32 or bfloat16, got {post_impact.dtype}")
    check_tensors(post_impact, (
        (post_impact, post_impact.dtype, "post_impact", 1),
        (post_local, torch.uint8, "post_local", 1),
        (tr_range, torch.int32, "tr_range", 1),
        (tr_start, torch.int32, "tr_start", 1),
        (grp_ids, torch.int32, "grp_ids", 2),
    ))
    if post_local.shape != post_impact.shape:
        raise ValueError("post_impact and post_local must be equal length")
    if tr_start.numel() != tr_range.numel() + 1:
        raise ValueError("tr_start must have one entry more than tr_range")
    if not 1 <= rs <= 256:
        raise ValueError(f"range_size must be in [1, 256], got {rs}")
    if min(grp_ids.shape) < 1:
        raise ValueError(f"grp_ids must be [q, G] with q, G >= 1, got {tuple(grp_ids.shape)}")


def exact_compact_accumulate_plain(
    post_impact, post_local, tr_range, tr_start, grp_ids, grp_ord, n_ord: int,
    n_docs: int, range_size: int,
):
    """Plain PyTorch version of ``exact_compact_accumulate``: per term
    ordinal in ascending order, the reference's fixed-width gather of that
    ordinal's groups (``search/exact.py:123-133``), every lane added into the
    accumulator (lanes past a group's length add 0.0 to the pad doc)."""
    q, g_width = grp_ids.shape
    rs = range_size
    dev = grp_ids.device
    acc = new_accumulator(q, n_docs, dev)
    flat, stride = _flat_rows(acc)
    groups, ords = grp_ids.reshape(-1), grp_ord.reshape(-1)
    rs_iota = torch.arange(rs, dtype=torch.int32, device=dev)
    for o in range(n_ord):
        sel = torch.nonzero(ords == o).squeeze(1)
        if sel.numel() == 0:
            continue
        g = groups[sel].long()
        start = tr_start[g]
        length = tr_start[g + 1] - start  # contiguous groups
        rngs = tr_range[g].clamp_max((n_docs // rs) + 1)
        valid = rs_iota < length[:, None]
        gidx = torch.where(valid, start[:, None] + rs_iota, 0).long()  # [T, RS]
        sc = torch.where(valid, post_impact[gidx].float(), 0.0)
        doc = torch.where(valid, rngs[:, None] * rs + post_local[gidx].int(), n_docs)
        idx = (sel // g_width)[:, None] * stride + doc.long()
        flat.index_add_(0, idx.reshape(-1), sc.reshape(-1))
    return acc


def compact_rows_in_layout(grp_ids, grp_ord, tr_range, n_ord: int, n_docs: int, range_size: int):
    """[q] bool: whether each row of a group matrix keeps the layout E3's
    parallel path relies on (``csrc/exact_compact.cu``, L1 and L2): the
    groups with an ordinal in [0, n_ord) first, in non-decreasing ordinal
    order, pads after them, and inside one ordinal clamped ranges that
    strictly rise.  The kernel serves any other row with one thread a
    block, in the reference's order."""
    real = (grp_ord >= 0) & (grp_ord < n_ord)
    g = grp_ids.long()
    known = real & (g >= 0) & (g < tr_range.numel())
    r = tr_range[g.clamp(0, tr_range.numel() - 1)]
    rng = torch.where(known & (r >= 0), r.clamp_max(n_docs // range_size + 1), -1)
    key = torch.where(real, grp_ord, _INT_MAX)
    po, co, pr, cr = key[:, :-1], key[:, 1:], rng[:, :-1], rng[:, 1:]
    follows = (po < co) | ((po == co) & (pr < cr))
    return ((co == _INT_MAX) | ((po != _INT_MAX) & follows)).all(dim=1)


def exact_compact_accumulate(
    post_impact, post_local, tr_range, tr_start, grp_ids, grp_ord, n_ord: int,
    n_docs: int, range_size: int,
):
    """``[q, n_docs + 1]`` f32 accumulator of every group's impacts.

    post_impact [P] f32 or bf16 and post_local [P] u8, the range index's
    posting streams; tr_range [M+1] int32 (pad slot M: INT_MAX), tr_start
    [M+2] int32 (slots M and M+1 hold the total: the pad group is empty);
    grp_ids [q, G] int32 (term, range) group ids (pad = M); grp_ord [q, G]
    int32, each group's term ordinal inside its query, -1 for a pad; n_ord,
    one more than the largest ordinal.  The live mask and the filter are
    the caller's, after the sum.  A CUDA tensor launches the kernel once
    (none for n_ord = 0) or raises; a CPU tensor runs the plain version."""
    _check_compact(post_impact, post_local, tr_range, tr_start, grp_ids, range_size)
    _check_ordinals(grp_ord, grp_ids, n_ord, "grp_ord")
    args = (
        post_impact, post_local, tr_range, tr_start, grp_ids, grp_ord, n_ord,
        n_docs, range_size,
    )
    if post_impact.device.type == "cpu":
        return exact_compact_accumulate_plain(*args)
    if post_impact.device.type != "cuda":
        raise ValueError(f"unsupported device {post_impact.device}")
    return compact_scatter(new_accumulator(grp_ids.shape[0], n_docs, post_impact.device), *args)


def compact_scatter(
    acc, post_impact, post_local, tr_range, tr_start, grp_ids, grp_ord,
    n_ord: int, n_docs: int, range_size: int,
):
    """E3's launch alone: add every group's impacts into ``acc``, a
    ``[q, n_docs + 1]`` f32 row view (unit column stride) on the inputs'
    CUDA device, and return it.  ``exact_compact_accumulate`` calls it on a
    fresh zero accumulator; on one that holds sums it adds to them (timing
    the launch without its zero-fill).  Raises where the kernel cannot
    take the inputs or the launch fails."""
    global COMPACT_LAUNCHES

    _check_compact(post_impact, post_local, tr_range, tr_start, grp_ids, range_size)
    _check_ordinals(grp_ord, grp_ids, n_ord, "grp_ord")
    q, g_width = grp_ids.shape
    if (
        post_impact.device.type != "cuda"
        or acc.device != post_impact.device
        or acc.dtype != torch.float32
        or acc.shape != (q, n_docs + 1)
        or acc.stride(1) != 1
    ):
        raise ValueError(f"acc must be a float32 [{q}, {n_docs + 1}] row view on the inputs' CUDA device")
    if q * g_width >= 1 << 31:
        raise ValueError(f"{q * g_width} groups exceed the kernel's int32 group index")
    if n_ord == 0:
        return acc

    from ._build import library

    lib = library()
    with torch.cuda.device(acc.device):
        err = lib.bm25_exact_compact_accumulate(
            post_impact.data_ptr(), post_local.data_ptr(), tr_range.data_ptr(),
            tr_start.data_ptr(), grp_ids.data_ptr(), grp_ord.data_ptr(),
            acc.data_ptr(), q, g_width, n_ord, acc.stride(0), n_docs,
            range_size, tr_range.numel(), post_impact.numel(),
            int(post_impact.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"exact_compact_accumulate kernel launch failed: cudaError {err}")
    COMPACT_LAUNCHES += 1
    return acc
