"""The sharded index's device code: the cross-shard top-k merge (SH-merge),
the global statistics step (SH-stats) and the device build's posting sort
(D1-sort).

The reference runs one shard a mesh device and joins them with collectives
(``vectorchord_bm25_tpu/parallel/shard.py``, ``parallel/devbuild.py``).  On
one card the port stacks the shards along a leading dimension: an
``all_gather`` becomes a read of the stacked tensor and a ``psum`` a sum over
that dimension.  Each function here is a CUDA kernel on a CUDA tensor and
its plain PyTorch version on a CPU tensor; on a CUDA tensor it launches the
kernel or raises, never falls back:

- ``shard_merge`` (``csrc/shard_merge.cu``): the shards' local top-ks, a
  ``[D, Q, W]`` pair of sorted runs with local ids, their widths and the
  shards' doc offsets, to the ``kk`` best of each query by (score desc, id
  asc) in global ids: the reference's rebase (``g_ids``), ``all_gather``
  and ``lax.sort((-s, id), num_keys=2)[:, :kk]`` (``shard.py:820-832,
  1686-1692, 1840-1846, 1997-2003``), as one launch that merges the runs
  without a sort;
- ``shard_stats`` (``csrc/shard_stats.cu``): each shard's f64 sum of
  ``FIELDNORM_TO_LENGTH[doc_fn] * doc_live`` and the exclusive scan of the
  shard doc counts with their total (``global_stats_step``,
  ``shard.py:2285-2325``, and ``device_doc_offsets``, ``devbuild.py:65-91``);
- ``posting_sort`` (``csrc/posting_sort.cu``): every shard's postings sorted
  by (k0, k1, k2, k3, doc) with tf carried, in place (the
  ``lax.sort(..., num_keys=5)`` of ``devbuild.py:244-258``), by a stable LSD
  radix sort whose passes ``sort_passes`` plans from the kernel's census.

u32 columns travel as int32 tensors holding the same bits (torch covers
unsigned 32-bit types thinly); the kernels read them as u32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.fieldnorm import FIELDNORM_TO_LENGTH
from .blockmax_round import _check, _device_kind, _launch

__all__ = [
    "posting_sort",
    "posting_sort_plain",
    "sort_passes",
    "merged_pair",
    "shard_merge",
    "shard_merge_plain",
    "shard_stats",
    "shard_stats_plain",
]

# Kernel launches since import (or since a caller reset them), one a
# wrapper call that launched.  chip_smoke.py reads them to show the main
# path went through the kernels.
MERGE_LAUNCHES = 0
STATS_LAUNCHES = 0
SORT_LAUNCHES = 0
# The (slices, shards) grid of shard_stats' last launch, as its launcher
# set it; chip_smoke.py reports it against the card's SMs.
STATS_GRID = None
# The radix passes posting_sort's last call ran (each moves all six
# columns once); chip_smoke.py reports it.
SORT_PASSES = None

# shard_merge takes at most this many shards (kMaxShards of
# csrc/shard_merge.cu: its run table travels by value with the launch).
MAX_MERGE_SHARDS = 512

_INT32_MIN = -(1 << 31)
_LOW32 = 0xFFFFFFFF
_INT_MAX = (1 << 31) - 1


# ---------------------------------------------------------------------------
# SH-merge


def _total_order(x):
    """int32 float bits -> int32 whose signed order is IEEE total order (an
    involution)."""
    return x ^ ((x >> 31) & 0x7FFFFFFF)


def merge_keys(scores, ids):
    """int64 keys whose ascending order is ``lax.sort((-s, id))``'s: -s in
    IEEE total order, then id; a bijection, so the keys decode to the exact
    bits that went in."""
    neg = scores.contiguous().view(torch.int32) ^ _INT32_MIN
    return (_total_order(neg).long() << 32) | (ids.long() - _INT32_MIN)


def _unmerge_keys(keys):
    neg = _total_order((keys >> 32).int())
    scores = (neg ^ _INT32_MIN).view(torch.float32)
    return scores, ((keys & _LOW32) + _INT32_MIN).int()


def merged_pair(out):
    """``shard_merge``'s ``[2, Q, kk]`` int32 result as (scores [Q, kk] f32,
    ids [Q, kk] int32), views of it."""
    return out[0].view(torch.float32), out[1]


def _check_merge(scores, ids, widths, offsets, kk):
    dev = scores.device
    _check(
        (
            (scores, torch.float32, 3, "scores"),
            (ids, torch.int32, 3, "ids"),
            (offsets, torch.int64, 1, "offsets"),
        ),
        dev,
    )
    if scores.shape != ids.shape:
        raise ValueError("scores and ids must share one [D, Q, W] shape")
    d, _, w = scores.shape
    if offsets.numel() != d or len(widths) != d:
        raise ValueError(f"widths and offsets must hold one entry a shard ({d})")
    if d and (min(widths) < 0 or max(widths) > w):
        raise ValueError(f"widths must lie in [0, {w}], got {list(widths)}")
    if kk < 1:
        raise ValueError(f"kk must be >= 1, got {kk}")


def shard_merge_plain(scores, ids, widths, offsets, kk: int):
    """Plain PyTorch version of ``shard_merge``: the rebase, then every
    query's candidates sorted by their packed keys, padded with the pad key
    to ``kk`` and the first ``kk`` kept.  Raises ``ValueError`` where a run
    is not in merge order after the rebase (the kernel relies on it)."""
    _check_merge(scores, ids, widths, offsets, kk)
    _, q, _ = scores.shape
    pad = merge_keys(
        torch.tensor([float("-inf")]), torch.tensor([_INT_MAX], dtype=torch.int32)
    ).item()
    runs = [torch.full((q, kk), pad, dtype=torch.int64, device=scores.device)]
    for d, w in enumerate(int(x) for x in widths):
        s, i = scores[d, :, :w], ids[d, :, :w]
        g = torch.where(torch.isfinite(s), (i.long() + offsets[d]).int(), _INT_MAX)
        keys = merge_keys(s, g)
        if (keys[:, 1:] < keys[:, :-1]).any() or (keys > pad).any():
            raise ValueError(f"shard {d}'s runs are not in merge order after the rebase")
        runs.append(keys)
    keys = torch.cat(runs[1:] + runs[:1], dim=1).sort(dim=1, stable=True).values[:, :kk]
    s, i = _unmerge_keys(keys)
    return torch.stack((s.view(torch.int32), i))


def shard_merge(scores, ids, widths, offsets, kk: int):
    """The ``kk`` best of each query's candidates over every shard, in
    global ids.

    scores [D, Q, W] f32 and ids [D, Q, W] int32: shard ``d``'s local top-k
    of query ``q`` is its run ``[d, q, :widths[d]]``, ids local to the
    shard, in merge order (score descending in IEEE total order, then id
    ascending) after the rebase, as S2 (``dense_topk``) and Block-Max's
    running top-k leave it; the rest of a row is not read.  widths: ``D``
    ints in ``[0, W]`` (a shard that offered nothing has width 0).
    offsets [D] int64 on the device of ``scores``: each shard's first global
    id.  The rebase is the reference's ``g_ids``: id + offset where the
    score is finite, ``INT_MAX`` elsewhere.

    Returns one ``[2, Q, kk]`` int32 tensor, the scores' f32 bits then the
    global ids (``merged_pair`` views it as the pair), in the order of the
    reference's ``lax.sort((-s, id), num_keys=2)`` over the ``D * kk``
    rebased candidates of its padded top-ks: slots past the candidates hold
    ``(-inf, INT_MAX)``.  A CUDA tensor launches the kernel or raises; a CPU
    tensor runs the plain version."""
    global MERGE_LAUNCHES

    dev = scores.device
    if _device_kind(dev) == "cpu":
        return shard_merge_plain(scores, ids, widths, offsets, kk)
    _check_merge(scores, ids, widths, offsets, kk)
    d, q, w = scores.shape
    if d > MAX_MERGE_SHARDS:
        raise ValueError(f"shard_merge takes at most {MAX_MERGE_SHARDS} shards, got {d}")

    from ._build import library

    out = torch.empty((2, q, kk), dtype=torch.int32, device=dev)
    _launch(
        library().bm25_shard_merge, "shard_merge", dev,
        scores.data_ptr(), ids.data_ptr(), (ctypes.c_int * d)(*widths),
        offsets.data_ptr(), out.data_ptr(), d, q, w, kk,
    )
    MERGE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# SH-stats


_LENGTH_TABLES = {}


def _length_table(device):
    """``FIELDNORM_TO_LENGTH`` as f64 on ``device``, uploaded on the first
    call there and cached: a later call copies nothing."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _LENGTH_TABLES.get(device)
    if table is None:
        table = torch.from_numpy(FIELDNORM_TO_LENGTH.astype(np.float64)).to(device)
        _LENGTH_TABLES[device] = table
    return table


def shard_stats_plain(doc_fn, doc_live, counts):
    """Plain PyTorch version of ``shard_stats``."""
    table = _length_table(doc_fn.device)
    partial = (table[doc_fn.long()] * doc_live.double()).sum(dim=1)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=counts.device)
    offsets[1:] = counts.long().cumsum(0)
    return partial, offsets


def shard_stats(doc_fn, doc_live, counts):
    """Per-shard statistics of a stacked index in one launch.

    doc_fn [D, M] uint8 fieldnorms, doc_live [D, M] f32 (0/1), counts [D]
    int64 shard doc counts.  Returns (partial [D] f64: each shard's sum of
    ``FIELDNORM_TO_LENGTH[doc_fn] * doc_live``, offsets [D + 1] int64: the
    exclusive scan of ``counts`` followed by their total).  The sums are of
    integers below 2^53, so they are exact in any order.  A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    global STATS_LAUNCHES, STATS_GRID

    dev = doc_fn.device
    _check(
        (
            (doc_fn, torch.uint8, 2, "doc_fn"),
            (doc_live, torch.float32, 2, "doc_live"),
            (counts, torch.int64, 1, "counts"),
        ),
        dev,
    )
    d, m = doc_fn.shape
    if doc_live.shape != doc_fn.shape or counts.numel() != d or d < 1:
        raise ValueError("doc_fn and doc_live must be [D, M] and counts [D], D >= 1")
    if _device_kind(dev) == "cpu":
        return shard_stats_plain(doc_fn, doc_live, counts)

    from ._build import library

    lib = library()
    partial = torch.empty(d, dtype=torch.float64, device=dev)  # zeroed by the launch
    offsets = torch.empty(d + 1, dtype=torch.int64, device=dev)
    grid = (ctypes.c_int * 2)()
    _launch(
        lib.bm25_shard_stats, "shard_stats", dev,
        doc_fn.data_ptr(), doc_live.data_ptr(), _length_table(dev).data_ptr(),
        counts.data_ptr(), partial.data_ptr(), offsets.data_ptr(), d, m,
        ctypes.addressof(grid),
    )
    STATS_LAUNCHES += 1
    STATS_GRID = (grid[0], grid[1])
    return partial, offsets


# ---------------------------------------------------------------------------
# D1-sort


def _unsigned(col):
    """int32 bits -> their u32 value as int64."""
    return col.long() & _LOW32


def posting_sort_plain(cols):
    """Plain PyTorch version of ``posting_sort``: stable sorts from the
    least significant key up (doc, k3, k2, k1, k0), each row on its own.
    Returns new tensors."""
    k0, k1, k2, k3, doc, tf = cols
    perm = torch.arange(doc.shape[1], device=doc.device).expand(doc.shape[0], -1)
    for key in (doc.long(), _unsigned(k3), _unsigned(k2), _unsigned(k1), _unsigned(k0)):
        order = key.gather(1, perm).sort(dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return tuple(c.gather(1, perm) for c in cols)


# posting_sort's census: per row, for each key word (k0-k3, doc) the OR of
# its complement and its OR, then 1 where the doc column decreases somewhere.
_CENSUS = 11
_DOC_WORD = 4
_SORT_TILE = 4096  # postings a tile of the count and scatter launches


def sort_passes(census):
    """The radix passes of a stable LSD sort by (k0, k1, k2, k3, doc) that
    change some row, least significant first: ``(word, shift)`` pairs,
    word 0-3 for k0-k3 and 4 for doc, an 8-bit digit at ``shift``.

    ``census``: ``[D, 11]`` u32 values (any integer dtype) as the kernel
    writes them.  A digit whose byte has no varying bit in any row (one
    histogram bin in every row) is skipped: a stable pass would not move a
    posting.  The four doc passes are skipped where every row's doc column
    is already non-decreasing: a stable sort by doc is then the identity."""
    census = np.asarray(census, dtype=np.int64) & _LOW32
    varying = np.bitwise_or.reduce(census[:, :5] & census[:, 5:10], axis=0)
    words = ([_DOC_WORD] if census[:, 10].any() else []) + [3, 2, 1, 0]
    return [
        (w, shift) for w in words for shift in (0, 8, 16, 24)
        if (int(varying[w]) >> shift) & 0xFF
    ]


def posting_sort(cols):
    """Sort every shard's postings by (key, doc), in place.

    cols: six [D, P] int32 tensors, k0-k3 (the four big-endian u32 words of
    the 16-byte term keys, as their bits), doc (shard-local ids) and tf (u32
    bits); P a power of two >= 2.  Each row is sorted ascending by (k0, k1,
    k2, k3) unsigned, then doc (signed), with tf carried; equal (key, doc)
    pairs keep their input order, as in the plain version.  Returns
    ``cols``.  A CUDA tensor launches the kernel (a census, one read of it
    by the host, then the passes ``sort_passes`` plans; ``SORT_PASSES``
    counts them) or raises; a CPU tensor runs the plain version and copies
    its result back."""
    global SORT_LAUNCHES, SORT_PASSES

    cols = tuple(cols)
    if len(cols) != 6:
        raise ValueError("posting_sort takes six columns: k0, k1, k2, k3, doc, tf")
    dev = cols[0].device
    _check(
        tuple(
            (c, torch.int32, 2, name)
            for c, name in zip(cols, ("k0", "k1", "k2", "k3", "doc", "tf"))
        ),
        dev,
    )
    d, p = cols[0].shape
    if any(c.shape != cols[0].shape for c in cols):
        raise ValueError("the six columns must share one [D, P] shape")
    if d < 1 or p < 2 or p & (p - 1):
        raise ValueError(f"columns must be [D >= 1, P a power of two >= 2], got {(d, p)}")
    if _device_kind(dev) == "cpu":
        for c, s in zip(cols, posting_sort_plain(cols)):
            c.copy_(s)
        return cols

    from ._build import library

    lib = library()
    ptrs = [c.data_ptr() for c in cols]
    census = torch.empty((d, _CENSUS), dtype=torch.int32, device=dev)
    _launch(
        lib.bm25_posting_sort_census, "posting_sort", dev, *ptrs, d, p,
        census.data_ptr(),
    )
    passes = sort_passes(census.cpu().numpy())  # the sort's one read by the host
    if passes:
        n_tiles = -(-p // _SORT_TILE)
        scratch = torch.empty((6, d, p), dtype=torch.int32, device=dev)
        counts = torch.empty((d, 256, n_tiles), dtype=torch.int32, device=dev)
        totals = torch.empty((d, 256), dtype=torch.int32, device=dev)
        plan = (ctypes.c_int * (2 * len(passes)))(*(x for step in passes for x in step))
        _launch(
            lib.bm25_posting_sort_passes, "posting_sort", dev, *ptrs,
            scratch.data_ptr(), counts.data_ptr(), totals.data_ptr(),
            ctypes.addressof(plan), len(passes), d, p,
        )
    SORT_LAUNCHES += 1
    SORT_PASSES = len(passes)
    return cols
