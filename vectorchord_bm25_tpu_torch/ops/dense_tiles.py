"""The doc-tile walk S1 and E1 share (``csrc/dense_tiles.cuh``), stated in
PyTorch: the row split into tiles, the layout rule a query's list of
windows must keep for the parallel walk, and the windows a block takes.

The kernels write a dense ``[n_q, stride]`` accumulator once: a block owns
the cells ``[tlo, thi)`` of one query row in shared memory, takes the
windows whose docs can fall inside, adds them one term-ordinal run at a
time, and writes the tile.  Which windows can fall inside follows from the
layout of a list (the planning's, checked by every block):

- (L1) real windows first, ordinals non-decreasing; pads after them;
- (L2) inside one ordinal the windows' first docs strictly rise;

and from a run being one term's posting list cut into windows in doc
order, so a window's docs lie in [its first doc, the next window's first
doc).  A block whose list breaks L1 or L2 adds every window in the
reference's order, one lane at a time (exact and slow); the plain versions
never look at the layout.  The CPU tests hold these statements to numpy
and pin every planner that feeds S1 or E1 to the layout.
"""

from __future__ import annotations

import torch

__all__ = [
    "PAD",
    "TILE",
    "lists_in_layout",
    "span_windows",
    "taken_windows",
    "tile_split",
]

#: The widest doc tile a block owns, in f32 cells (shared memory 4 B each).
TILE = 8192

#: The ordering key of a pad entry.
PAD = (1 << 31) - 1


def tile_split(stride: int, tile: int = TILE):
    """(width, n_tiles): the launch's split of a row of ``stride`` cells (a
    multiple of 4) into equal tiles no wider than ``tile`` (a multiple of
    4), each a multiple of 4 wide, none empty.  Tile j owns
    ``[j * width, min((j + 1) * width, stride))``."""
    if stride < 4 or stride % 4 or tile < 4 or tile % 4:
        raise ValueError(f"stride {stride} and tile {tile} must be positive multiples of 4")
    n_tiles = -(-stride // tile)
    width = (-(-stride // n_tiles) + 3) & ~3
    return width, -(-stride // width)


def span_windows(q_start, n_list: int):
    """(entry [E] int64, query [E] int64): the entries of each query's span
    ``[q_start[q], q_start[q + 1])`` of a list of ``n_list`` windows, as the
    kernel clamps them (to the list, an end below its start: empty), in
    query and list order."""
    lo = q_start[:-1].long().clamp(0, n_list)
    hi = torch.maximum(q_start[1:].long().clamp(0, n_list), lo)
    counts = hi - lo
    query = torch.repeat_interleave(torch.arange(counts.numel(), device=q_start.device), counts)
    first = torch.cumsum(counts, 0) - counts
    entry = lo[query] + torch.arange(query.numel(), device=q_start.device) - first[query]
    return entry, query


def lists_in_layout(key, first, bad, query, n_lists: int):
    """[n_lists] bool: whether each list keeps L1 and L2.

    key [E] int: each entry's ordinal, ``PAD`` for a pad; first [E] int its
    first doc (real entries); bad [E] bool a real entry the kernel cannot
    place; query [E] int64 its list, the entries of a list consecutive and
    in list order."""
    real = key != PAD
    broken = real & bad
    same = query[1:] == query[:-1]
    pk, ck, pf, cf = key[:-1], key[1:], first[:-1], first[1:]
    follows = (ck == PAD) | ((pk != PAD) & ((pk < ck) | ((pk == ck) & (pf < cf))))
    broken[1:] |= same & ~follows
    ok = torch.ones(n_lists, dtype=torch.bool, device=key.device)
    ok[query[broken]] = False
    return ok


def taken_windows(key, first, tlo: int, thi: int):
    """[L] bool: the windows of one list (in order, on the layout) a block
    owning the cells ``[tlo, thi)`` takes: in each run, the last window
    whose first doc is <= ``tlo`` and every window whose first doc lies
    inside the tile (the binary search on first docs, evaluated entry by
    entry as the kernel does)."""
    real = key != PAD
    nkey = torch.cat((key[1:], key.new_full((1,), PAD)))
    nfirst = torch.cat((first[1:], first.new_zeros(1)))
    return real & (first < thi) & ((nkey != key) | (nfirst > tlo))
