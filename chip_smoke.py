#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU: the Block-Max engine (f32
and bf16 impacts, tf postings, the exhaustive range sweep; at 131,072 and
at 2,097,152 docs), the served default, the stream engine, with a growing
segment and at the scale where its ``auto`` strategy leaves the dense path,
the exact engine (dense, bf16, compact, shared and sparse), the hybrid
engine's routes, a restart (checkpoint, WAL replay, reopen), the
sharded index (8 shards stacked on the card: its device build, every
engine, a restart, and serving at 2,097,152 docs), and the text path: a
generated corpus of raw text built out of core and evaluated, and the
command line driven over the same texts.  The
corpora come from the port's own generators
(``vectorchord_bm25_tpu_torch/data/synth.py``, ``data/stream_synth.py``).

    python3 chip_smoke.py [--docs N] [--sparse-docs N] [--seed S]

Phases (each prints its lines; any failure raises, so the exit code is
not 0 and no result line is printed):

  (a) the card's ``name, power.limit``, torch and CUDA versions;
  (b) build the CUDA kernel library from ``vectorchord_bm25_tpu_torch/csrc``
      with nvcc for sm_90a, one nvcc per source at once, and print ptxas'
      register and shared-memory lines;
  (c) the kernel against its plain PyTorch version on the card, on the
      windows the engine hands it at the slice's shapes (Q=4096, T=4,
      C=32, RS=128 at the default size; must be equal) and on random
      windows with colliding slots (rtol 1e-5, atol 1e-6), with both
      times from CUDA events and its bound, on round 1's windows and on the
      batch's last round's (most of its queries have no window); and the
      rest of the round, B1-bounds
      (``range_bounds``), B1-select (``round_select``) and B1-merge
      (``round_merge``), each against its plain version on every call of a
      4,096-query batch (``torch.equal`` on every output and on every tensor
      updated in place; R=1,024, k=16), timed on the first round's inputs
      (on the card, launches queued behind a sleeping kernel, and back to
      back) beside the library call nearest to it (``torch.topk`` on the same rows
      or packed keys, which computes only the selection), and B1-merge also
      on the batch's last round's inputs, with the share of its queries
      whose lanes are all zero;
  (d) the slice: ``Bm25Index(..., engine="blockmax", device="cuda")``
      over a 131,072-doc synthetic corpus (bench.py's default size,
      trec-covid scale) serving ``search_batch(k=10)`` in 4,096-query
      batches; P1's and the three B1 kernels' launch counts must grow; one
      batch under ``torch.profiler``, with P1's, B1-select's and B1-merge's
      totals named (P1's goes into the ``kernels`` line);
  (e) correctness at that size: 256 sampled queries equal the same
      engine on the CPU (plain kernel), also after deleting 1% of the
      payloads and under a prefilter; recall@10 = 1.0 against the
      float64 oracle, excusing f32 boundary ties as bench.py does;
      ``last_rounds`` on the card equals the CPU-plain engine's (also in
      (l), (m) and (s));
  (f) the served default: ``Bm25Index(seg, seed, IndexOptions(),
      device="cuda")`` (engine "stream", dense below 2^21 docs) on the same
      corpus.  On every dispatch the engine hands its kernels, S1
      (``stream_dense_accumulate``, its spans on the planning's layout)
      and S2 (``dense_topk``) must equal their plain versions
      (``torch.equal``, S1's padded rows included); both and their plain
      versions are timed with CUDA events on the first dispatch, S1 also
      at each doc tile of ``TILE_SWEEP`` and beside the old ``torch.zeros``
      fill alone, S2 also beside ``torch.topk`` on the same rows; S2 on
      rows with 0 to k - 1 positive docs, both branches, equals its plain
      version, pad ids included.  Then 5 batches of 4,096 queries at k=10,
      QPS each; both launch counts must grow; one batch profiled, with
      S2's share of the card's busy time, S1's and any fill's;
  (g) 256 sampled queries equal the same facade on the CPU (plain
      versions), also after deleting 1% and under a prefilter; recall@10
      = 1.0 against the float64 oracle; ``memory_report()["total"]``
      equals the bytes of the stream's host arrays;
  (h) 1,024 inserted docs (the term counts of corpus docs, so every term
      is known) served by ``search_batch`` through the growing segment's
      stream engine on the card: equal to the CPU, every S1 call of a
      batch equal to its plain version, and its S1 launches grow;
  (l) bf16 impacts on the same corpus and RangeIndex:
      ``Bm25Index(..., engine="blockmax", engine_options={"impact_dtype":
      "bfloat16", "range_index": ri})``.  On every round's windows P1 on
      bf16 equals its plain version (``torch.equal``), both timed; every B1
      call of a batch held and timed as in (c); 5
      batches of 4,096 at k=10, QPS each, its launches must grow; 256
      queries equal the CPU-plain run; every rank's score within rtol 6e-3
      of the f32 engine's (the reference's own tolerance), recall@10
      against it printed; ``memory_report()["total"]`` equals the
      reference's formula;
  (m) ``posting_mode="tf"``: the same with P1-tf (``tf_range_scores``)
      and B1 held as in (l), P1-tf timed on round 1 and on the batch's
      last round (on the card and back to back, beside its plain version
      and bound), then phase (e)'s audit (card == CPU-plain, also after deleting 1%
      and under a prefilter; recall@10 = 1.0 against the float64 oracle);
  (n) the exhaustive sweep ``search_rangescan_async`` on phase (d)'s f32
      engine: P1 on every chunk and S2 on the accumulator equal their
      plain versions, both timed (P1 also written at the accumulator's row
      stride, as the sweep writes it; S2 beside ``torch.topk``); 3 batches of 4,096 queries, QPS each,
      P1's and S2's launches must grow; ids and scores equal the pruned
      engine's on all 4,096 queries and the CPU-plain engine's on 256;
  (o) ``engine="exact"``, dense f32 rows: ``Bm25Index(seg, seed,
      IndexOptions(), engine="exact", device="cuda")`` on the same corpus.
      On every dispatch's windows E1 (``exact_dense_accumulate``) equals
      its plain version (``torch.equal``), both timed on the largest
      dispatch (its rows on the planning's layout), E1 also at each doc
      tile and with a filter fused into its write beside the separate
      ``mul_`` pass it replaces; 5 batches of 4,096 at k=10, QPS each and
      the dispatches a
      batch; then phase (e)'s audit (card == CPU-plain, also after deleting
      1% and under a prefilter; recall@10 = 1.0 against the float64
      oracle); ``memory_report()["total"]`` equals the reference's formula;
  (p) the same index with bf16 rows (E1 on bf16 equals its plain version;
      scores per rank within rtol 6e-3 of the f32 engine's, recall@10
      against it printed), with ``compact=True`` and as
      ``ExactEngine(share=<phase (d)'s BlockMaxEngine>)``: E3
      (``exact_compact_accumulate``) equals its plain version on every
      dispatch, and is timed on the largest with and without its
      accumulator's zero-fill (on the card and back to back, each beside
      its bound; its rows must keep the planning's layout, so the parallel
      path is the one timed); hit counts equal the dense f32 engine's, a rank may differ
      only between scores within 1e-4, scores within rtol 1e-5; the shared
      engine's tensors are Block-Max's (``data_ptr()``);
  (q) ``engine="hybrid"`` on phase (d)'s RangeIndex: (1) the default
      ``heavy_mode``: every query goes to the exact engine, every E1 call
      of a batch equals its plain version, the Block-Max engine is never
      built, results equal phase (o)'s; (2)
      ``heavy_mode="pruned"``, ``memory_mode="compact"``, ``oneshot_cap=64``:
      queries by route printed, P1's launches must grow, ids equal phase
      (o)'s on all 4,096 queries and scores within rtol 1e-5,
      ``memory_report()`` is one copy by the reference's formula; (3)
      ``heavy_mode="rangescan"``: P1's and S2's launches grow, every E1
      call of a batch equals its plain version, the same equality.
      ``route_threshold`` starts at the default 0.10 and is
      lowered (printed) until some query takes the heavy route;
  (i) the served default at scale: a 2,097,152-doc corpus (``--sparse-docs``;
      the same generator and shape, only the doc count raised, the
      smallest size at which ``auto`` leaves the dense path), served by
      ``Bm25Index(seg, seed, IndexOptions(), device="cuda")``.  One
      512-query batch of informative queries (``synth_queries_fast``) and
      one of heavy ones (``synth_queries_from_segment(mix="heavy")``), k=10:
      on every dispatch the engine hands them, SP-stream
      (``stream_sparse_topk``: the whole sparse reduction in one launch,
      pad ids included) and S5 (``rescore_topk``: scores and the top-k in
      one launch, ids included; its scores-only entry ``stream_rescore``
      held on the same inputs) must equal their plain versions
      (``torch.equal``); SP-stream timed with CUDA events on its largest
      dispatch and on its deepest pool's, on the card (launches queued
      behind a sleeping kernel) and back to back, beside the parent's chain
      on the same inputs (S3 ``stream_sparse_decode``, the stable sort, S4
      ``sparse_combine``, ``select_keys``: equal to it, and S3 and S4 each
      held to their plain versions and timed there); S5 beside its
      scores-only launch, the two-step scores-then-``lex_topk`` and
      ``torch.topk`` on the packed keys.  Then 5 batches of each mix, QPS
      each and ``last_ms_stats``; SP-stream's and S5's launch counts must
      grow from 0, S3's and S4's stay 0, and the heavy mix must route
      queries to MaxScore; one heavy batch profiled, SP-stream's and S5's
      launches named, and no radix sort or ``sbtopk``/``mbtopk`` row; one
      more heavy batch with each SP-stream and S5 call timed again on its
      inputs on the card;
  (j) 64 sampled queries (32 of each mix): the card equals the CPU-plain
      engine under ``auto``, ``sparse`` and ``maxscore``, also after
      deleting 1% and under a prefilter, every SP-stream call held to its
      plain version; recall@10 = 1.0 against the float64 oracle on 32 of
      them; ``memory_report()["total"]`` equals the bytes of the stream's
      host arrays;
  (r) ``ExactEngine(seg, device="cuda")`` on phase (i)'s corpus, where
      ``strategy="auto"`` is the sparse path: SP-exact
      (``exact_sparse_topk``, one launch a dispatch) equals its plain
      version on every dispatch of a batch of each mix, timed on the
      largest beside the parent's chain (E2 ``exact_sparse_gather``, the
      sort, S4, ``select_keys``; E2 and S4 held there too); the peak device
      memory of those batches; 3 batches of 512 of each mix with SP-exact's
      launches growing and E2's and S4's at 0; the card equals the
      CPU-plain engine on 64 queries; recall@10 = 1.0 against the float64
      oracle on 256;
  (s) ``BlockMaxEngine`` on phase (i)'s corpus (16,384 ranges, chunk 256):
      B1 equal to its plain versions on every call of the 512-query
      informative batch and timed at that size; 3 batches, rounds and QPS
      each; the card equals the CPU-plain engine on 32 queries;
  (t) restart, on phase (f)'s stream index (after (h)) and phase (d)'s
      Block-Max index (after (q)), each with its deletes: ``save_index``,
      ``open_index(dir, device="cuda")``, one 4,096-query batch equal to the
      live index's; 1,024 inserts and another 1% deleted through the opened
      index with no checkpoint, reopened, the WAL replays, equal to the live
      index after the same mutations; ``maintain``, save, open: ``wal.log``
      empty, one generation left, results equal; bytes on disk and the host
      seconds of each step, the save and the open on the native codecs
      (``native/loader.py`` must have built its library) beside the numpy
      codecs' times recorded in PERF.md;
  (u) the sharded index on phase (d)'s postings in 8 shards:
      ``ShardedIndex.build_from_postings(..., 8, device="cuda",
      device_build=True)``, where D1-sort (``posting_sort``) equals its plain
      version on all six columns and SH-stats (``shard_stats``) its plain
      version and the host's (N, sum dl) and doc offsets, and the segments
      equal ``device_build=False``'s.  Then engines ``stream``, ``exact``,
      ``hybrid`` (fast and compact) and ``blockmax`` (impact and tf) on those
      shards: one 4,096-query batch at k=10 with every call of every kernel
      on the path (S1, S2, E1, E3, B1, P1 or P1-tf, SH-merge) held
      ``torch.equal`` to its plain version, then 3 batches with the counters
      from 0 (each must grow), QPS each; S2 timed on one shard's
      accumulator (its flat branch, below 2^17 docs) beside its plain
      version and ``torch.topk``; SH-merge timed on each body's largest
      call (on the card, back to back, plain, ``torch.topk`` on the packed
      rebased keys, bound) and one batch profiled for its dispatch census
      (SH-merge launches, torch's kernels, fills and copies a dispatch);
      256 queries equal the same sharded
      index on the CPU (plain kernels); recall@10 = 1.0 against the float64
      oracle.  Then the stream index restarts: save, open with the WAL,
      1,024 inserts and 1% deleted through it, a prefilter, maintain, reopen
      (the WAL replays), each step equal to the live index; bytes on disk
      and host seconds;
  (v) the device build of phase (i)'s postings (2,097,152 docs, 8 shards of
      262,144): D1-sort and SH-stats held as in (u); D1-sort timed with
      its plain version and five chained stable ``torch.sort`` passes on the
      staged rows (the doc passes skipped) and on the same rows shuffled
      (held to its plain version there too), with the radix passes the
      wrapper reports and the device memory its calls take; SH-stats with
      its plain version and ``torch.sum``; host seconds of packing, sort,
      flush and upload, and the peak device memory;
  (w) (v)'s index serving both 512-query mixes, ``strategy="auto"`` (dense
      per shard: 262,144 docs a shard is below 2^21) and ``"maxscore"``:
      one batch with every kernel call held to its plain version (S1, S2,
      SH-merge; SP-stream and S5 under MaxScore), then 5 batches, QPS each;
      the informative batch profiled (SP-stream's, S5's, radix-sort and
      torch top-k rows named); results held
      to phase (i)'s single index by the reference's rule (the same hit
      counts, a rank may differ only between scores within 1e-4, scores
      within rtol 2e-5); 32 queries equal the CPU-plain sharded index under
      both strategies; recall@10 = 1.0 on them; SH-merge timed on its largest
      call (``[8, 512, 16]``) as in (u);
  (x) from raw text to ranked, evaluated results:
      ``generate_streaming("msmarco-mini")`` (200,000 docs of text, 512
      queries with qrels) built by ``build_index_streaming(ds,
      engine="stream", n_workers=min(8, cpus), device="cuda")``: spawned
      workers tokenize and intern, the native merger merges every run (the
      native library must load, and every merge must be native), the
      streaming flush, the served default on the card (dense: S1, S2);
      host seconds of the scan, the merge, the flush and the stream index's
      build and upload; ``run_dataset`` over all 512 queries in batches of
      64 at k=1000 (NDCG@10, recall@10/100/1000 beside the reference's
      0.703 and 1.0; recall@1000 must be 1.0) and at k=10 (QPS), S1's and
      S2's launches must grow; every S1 and S2 call of one k=1000 batch
      ``torch.equal`` to its plain version; 64 sampled queries at k=1000
      equal the same index on the CPU (plain versions), ids and scores;
      ``oracle_rank_parity`` at k=10 over all 512 queries must be 0; save
      and open through the native codecs, seconds and bytes on disk, the
      reopened index equal on the 64 queries;
  (y) the command line (``vectorchord_bm25_tpu_torch/cli.py``) over (x)'s
      texts, written as JSONL: ``cli.main(["build", ..., "--workers",
      min(8, cpus)])`` on the default device (the card; engine stream,
      dense), then 64 of (x)'s query texts through ``cli.main(["search",
      ...])`` at k=10 with stdout captured: every line equal to
      ``load_index`` in process on the card and on the CPU (plain
      versions), the hits held to (x)'s index by (w)'s rule (the seeds
      differ), S1's and S2's launches grown, one search's S1 and S2 calls
      ``torch.equal`` to their plain versions; one search as ``python -m
      vectorchord_bm25_tpu_torch.cli`` on the card and one with ``--device
      cpu``, each printing the in-process lines; insert (a payload past the
      corpus, found by search; the WAL replayed on the card), delete,
      maintain (``wal.log`` empty), inspect (equal to the index's values);
      ``build --engine blockmax`` on the same file, its hits held to the
      stream index, P1's and B1's launches grown, one batch's P1 and B1
      calls held to their plain versions; ``memory_parity_report`` of both
      and of (f)'s stream engine beside ``BENCH_r05.json``'s 0.732; two
      searches under ``utils/profiling.trace`` (the Chrome trace names S1,
      S2 and the annotation); ``tools/dryrun.dryrun_multichip(8,
      device="cuda")`` with D1-sort's, SH-stats' and SH-merge's launches
      grown; the host seconds of each step;
  (k) the host build time of each phase.

Phases (l)-(q) run after (h), while the 131,072-doc corpus is held, (u)
after (t), (r), (s), (v) and (w) after (j), (x) after (w) and (y) after (x).  Each path is driven with
its launch counters at 0 and read just after.  The ``kernels`` line lists
P1 (f32 and bf16), P1-tf, B1-bounds, B1-select, B1-merge, S1-S5,
SP-stream, E1 (f32 and bf16), E2, E3, SP-exact, SH-merge, SH-stats and
D1-sort (S3, S4 and E2 off the path: held and timed, 0 launches), each
with its launches
by phase and in all, its time and its plain version's from CUDA events, its bound
(``bound_ms``: the larger of its bytes over 3.35 TB/s and its f32
operations over 67 TFLOP/s, counted from this run's inputs) and the time
of one PyTorch call computing the same function where there is one
(``library_ms``); the last line of stdout is ``{"ok": true, "device":
{...}}``.  Needs torch with CUDA, nvcc and g++; imports no jax, nothing of
the JAX package and not ``bench.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

BATCH = 4096
K = 10
AUDIT = 256
ROUNDS = 5
SPARSE_BATCH = 512  # the reference's batch at its 8,388,608-doc scale
SPARSE_AUDIT = 64  # (j): half informative, half heavy queries
RECALL_QUERIES = 32


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of fn() on the current stream, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of fn() on the card alone: the launches queue up
    behind a sleeping kernel, so for a call that the host launches slower
    than the card runs it, the events time the card and not the host's
    launch pace (which ``cuda_ms`` measures)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms: longer than the enqueueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_fresh(fn, fresh, iters=20, warmup=3, queued=False):
    """Mean milliseconds of ``fn(*fresh())`` from CUDA events, for a function
    that updates an argument in place: every call gets arguments of its own,
    all made before the clock starts.  ``queued``: the launches wait behind
    a sleeping kernel, as in ``device_ms``, so the events time the card."""
    import torch

    argsets = [fresh() for _ in range(iters + warmup)]
    for a in argsets[:warmup]:
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
    start.record()
    for a in argsets[warmup:]:
        fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The doc tiles (f32 cells of shared memory a block owns) S1 and E1 are
# timed at, around the wrapper's default (``ops/dense_tiles.py``).
TILE_SWEEP = (2048, 4096, 8192, 16384, 32768)


def tile_sweep(fn):
    """Device ms of ``fn()`` at each doc tile of ``TILE_SWEEP``."""
    from vectorchord_bm25_tpu_torch.ops import dense_tiles

    default, out = dense_tiles.TILE, {}
    try:
        for tile in TILE_SWEEP:
            dense_tiles.TILE = tile
            out[tile] = device_ms(fn, iters=10)
    finally:
        dense_tiles.TILE = default
    return out


# The card's published peaks (NVIDIA's H100 SXM data sheet, dense rates),
# which a kernel's least time (``bound_ms``) is taken against.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores


def bound(n_bytes, n_ops):
    """The least time the card could take for work that must move
    ``n_bytes`` of device memory and do ``n_ops`` f32 operations: the
    larger of the two times, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": int(n_bytes),
        "bound_ops": int(n_ops),
    }


def rows_whole(acc):
    """An accumulator's rows with their stride padding (S2 reads it)."""
    return acc.as_strided((acc.shape[0], acc.stride(0)), (acc.stride(0), 1))


def window_words(si, wins):
    """u32 stream words the windows ``wins`` hold (pad windows none): each
    stores its lanes' doc deltas at dbits and tfs at tfbits."""
    wins = np.asarray(wins)
    wins = wins[wins < si.n_windows]
    ln = si.w_len[wins].astype(np.int64)
    dw = -(-ln * si.w_dbits[wins].astype(np.int64) // 32)
    tw = -(-ln * si.w_tfbits[wins].astype(np.int64) // 32)
    return int((dw + tw).sum()), int(ln.sum()), int(wins.size)


def p1_bound(post, starts, lens, rs):
    """P1 (any impact type) or P1-tf on these windows: each active lane's
    posting bytes (impact or tf, its u8 slot, and for tf its u8 fieldnorm),
    the [Q, T, C] starts and lengths, the [Q, C, RS] f32 output; one add
    (tf: a multiply, an add, a divide and the add) a lane."""
    import torch

    q, t, c = starts.shape
    active = int(lens.sum())
    tf = post.dtype in (torch.uint8, torch.int16)
    lane_bytes = post.element_size() + 1 + (1 if tf else 0)
    extra = (4 * q * t + 4 * q * c + 1024) if tf else 0  # s0, cand_r, s1
    return bound(
        active * lane_bytes + 8 * starts.numel() + 4 * q * c * rs + extra,
        active * (4 if tf else 1),
    )


def p1_fields(imp, loc, starts, lens, rs, out=None):
    """P1 timed on one call's inputs (CUDA events: on the card, the
    launches queued behind a sleeping kernel, and launched back to back),
    beside its plain version, with its bound from those inputs, the active lanes and the
    share of queries with no window at all (their rows are zeros).  With
    ``out`` the kernel writes into that strided view, as the range sweep
    does; the result is held ``torch.equal`` to the plain version."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import score_kernel

    def kernel():
        return score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs, out=out)

    got = kernel()
    want = score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs)
    torch.cuda.synchronize()
    if not torch.equal(got.reshape(want.shape), want):
        raise AssertionError("P1 != its plain version on a timed call")
    q, t, c = starts.shape
    return {
        "ms": device_ms(kernel),
        "launch_paced_ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(
            lambda: score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs),
            iters=5,
        ),
        **p1_bound(imp, starts, lens, rs),
        "active_lanes": int(lens.sum()),
        "inactive_queries": float((lens.reshape(q, -1).amax(dim=1) <= 0).float().mean()),
        "shape": {"Q": q, "T": t, "C": c, "RS": rs,
                  "row_stride": c * rs if out is None else out.stride(0)},
    }


def tf_fields(a, kw):
    """P1-tf timed on one recorded call (on the card, queued behind a
    sleeping kernel, and back to back) beside its plain version, with its
    bound from those inputs and the share of queries with no window."""
    from vectorchord_bm25_tpu_torch.ops import score_kernel

    starts, lens = a[6], a[7]
    q = starts.shape[0]
    return {
        "ms": device_ms(lambda: score_kernel.tf_range_scores(*a, **kw)),
        "launch_paced_ms": cuda_ms(lambda: score_kernel.tf_range_scores(*a, **kw)),
        "plain_ms": cuda_ms(lambda: score_kernel.tf_range_scores_plain(*a, **kw), iters=5),
        **p1_bound(a[0], starts, lens, kw["rs"]),
        "active_lanes": int(lens.sum()),
        "inactive_queries": float((lens.reshape(q, -1).amax(dim=1) <= 0).float().mean()),
    }


def s2_fields(acc, kk, n_docs):
    """S2 timed on one accumulator (CUDA events: on the card, and launched
    back to back) beside its plain version
    and ``torch.topk`` on the same rows (no score > 0 mask, no tie rule),
    with its bound: the doc columns read once and [Q, k] scores and ids
    written, a compare and a max a column."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import topk

    q = acc.shape[0]
    return {
        "ms": device_ms(lambda: topk.dense_topk(acc, kk, n_docs), iters=10),
        "launch_paced_ms": cuda_ms(lambda: topk.dense_topk(acc, kk, n_docs), iters=10),
        "plain_ms": cuda_ms(lambda: topk.dense_topk_plain(acc, kk, n_docs), iters=5),
        "library_ms": cuda_ms(lambda: torch.topk(acc[:, :n_docs], kk, dim=1), iters=5),
        **bound(4 * q * n_docs + 8 * q * kk, q * n_docs),
        "hierarchical": topk._hierarchical(acc.shape[1], kk, n_docs, 1024),
        "shape": {"Q": q, "M": acc.shape[1], "n_docs": n_docs, "k": kk},
    }


def s2_pads_check(n_q, n_docs, kk, seed):
    """S2 on accumulators whose rows hold 0 to kk - 1 positive docs (row r
    holds r % kk), both branches: the pads' ids depend on which blocks the
    kernel chose, so scores and every id must be ``torch.equal`` to the
    plain version.  Returns the rows checked."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import topk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = 0
    for n in (n_docs, 16384):
        acc = topk.new_accumulator(n_q, n, "cuda")
        cols = torch.randint(0, n, (n_q, kk), device="cuda", generator=gen)
        vals = torch.rand((n_q, kk), device="cuda", generator=gen) + 0.5
        keep = torch.arange(kk, device="cuda") < (torch.arange(n_q, device="cuda") % kk)[:, None]
        acc.scatter_(1, cols, torch.where(keep, vals, 0.0))
        acc[1::3, : n : 7] = -1.0  # non-positive lanes pad too
        got = topk.dense_topk(acc, kk, n)
        want = topk.dense_topk_plain(acc, kk, n)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"S2 != plain on rows with fewer than k positives ({n} docs)")
        if not (~torch.isfinite(got[0])).any():
            raise AssertionError("the pad check made no pad")
        rows += n_q
    return rows


def hits_of(results):
    return [[(h.score, h.payload) for h in hits] for hits in results]


def recall_vs_oracle(seg, queries, results, k):
    """recall@k of payload results vs the float64 oracle (bench.py's
    audit: a missing doc whose f64 score is within 2 f32 ulps of the kth
    score is an f32-resolution boundary tie, not a miss)."""
    from vectorchord_bm25_tpu_torch import oracle_scores, oracle_topk

    slot_of = {int(p): i for i, p in enumerate(seg.doc_payload)}
    hits = total = ties = 0
    for query, res in zip(queries, results):
        o_scores, o_ids = oracle_topk(seg, query, k, dtype=np.float64)
        got = {slot_of[p] for _, p in res}
        matched = got & set(int(x) for x in o_ids)
        missing = [int(x) for x in o_ids if int(x) not in got]
        if missing:
            sc = oracle_scores(seg, query, dtype=np.float64)
            kth = float(o_scores[-1]) if o_scores.size else 0.0
            tol = 2.0 * float(np.spacing(np.float32(abs(kth))))
            for d in missing:
                if abs(sc[d] - kth) <= tol:
                    ties += 1
                    matched.add(d)
        hits += len(matched)
        total += len(o_ids)
    return (hits / total if total else 1.0), total, ties


def doomed(p):
    """The 1% of payloads the audits delete."""
    return (np.asarray(p) * 2654435761) % 100 == 0


def keep(p):
    """The audits' prefilter."""
    return np.asarray(p) % 3 != 0


def audit(index, cpu, seg, sample):
    """Hold the card's index against the same index on the CPU (plain
    versions) on the sampled queries, check recall@K against the float64
    oracle, then delete 1% of the payloads on both and compare again, with
    and without a prefilter.  Raises on any difference; returns (recall,
    oracle hits, ties excused, docs deleted)."""
    from vectorchord_bm25_tpu_torch import SessionConfig

    gpu_hits = index.search_batch(sample, K)
    if hits_of(gpu_hits) != hits_of(cpu.search_batch(sample, K)):
        raise AssertionError("GPU results differ from the CPU-plain run")
    recall, total, ties = recall_vs_oracle(seg, sample, hits_of(gpu_hits), K)
    if recall != 1.0:
        raise AssertionError(f"recall@{K} vs oracle {recall} != 1.0")
    n_del = index.bulkdelete(doomed)
    if cpu.bulkdelete(doomed) != n_del or not n_del:
        raise AssertionError("bulkdelete counts differ or deleted nothing")
    for kw in ({}, {"filter_fn": keep, "session": SessionConfig(prefilter=True)}):
        got = hits_of(index.search_batch(sample, K, **kw))
        if got != hits_of(cpu.search_batch(sample, K, **kw)):
            raise AssertionError(f"GPU != CPU-plain after deletes {kw and '+ prefilter'}")
        bad = [p for hits in got for _, p in hits if doomed(p) or (kw and not keep(p))]
        if bad:
            raise AssertionError(f"deleted or filtered payloads returned: {bad[:5]}")
    return recall, total, ties, n_del


B1_NAMES = ("range_bounds", "round_select", "round_merge")
B1_COUNTERS = ("BOUNDS_LAUNCHES", "SELECT_LAUNCHES", "MERGE_LAUNCHES")
B1_REPLACES = (82, 114, 194)  # lines of the reference's search/blockmax.py


def b1_counters():
    """``_serve`` counters of the three B1 kernels (keys: their names)."""
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    return [(br, counter, name) for counter, name in zip(B1_COUNTERS, B1_NAMES)]


def b1_zero():
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    for counter in B1_COUNTERS:
        setattr(br, counter, 0)


def b1_read():
    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    return {name: getattr(br, counter) for counter, name in zip(B1_COUNTERS, B1_NAMES)}


def held_select(real, phase, ub_work, topk_s, rest, flag, kw):
    """One B1-select call through ``real`` held against
    ``round_select_plain`` on a copy of the same inputs: ``torch.equal`` on
    all four outputs and on the row updated in place."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    twin = ub_work.clone()
    out = real(ub_work, topk_s, *rest, flag=flag, **kw)
    want = br.round_select_plain(twin, topk_s, *rest, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(out, want)) or not torch.equal(ub_work, twin):
        raise AssertionError(f"{phase} round_select != its plain version")
    return out


@contextlib.contextmanager
def select_held(phase):
    """Inside, every B1-select call on the card is held to its plain
    version (``held_select``); yields the list whose length counts them."""
    from vectorchord_bm25_tpu_torch.search import blockmax

    real = blockmax.round_select
    calls = []

    def select(ub_work, topk_s, *rest, flag=None, **kw):
        if not ub_work.is_cuda:
            return real(ub_work, topk_s, *rest, flag=flag, **kw)
        calls.append(None)
        return held_select(real, phase, ub_work, topk_s, rest, flag, kw)

    blockmax.round_select = select
    try:
        yield calls
    finally:
        blockmax.round_select = real


def select_fields(ub0, ts0, rest, kw):
    """B1-select timed on one call's inputs (a fresh row each launch): the
    kernel's time on the card (launches queued behind a sleeping kernel) and
    launched back to back, its plain version's, ``torch.topk``'s on the same
    rows both ways, and its bound: the row read once, an active query's C
    taken ranges written back, the threshold, cand_r, start and length
    written, the active queries' spans searched; a compare a bound and
    log2(span) a search."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br

    tts, q_tid = rest[2], rest[3]
    q, n_ranges = ub0.shape
    t = q_tid.shape[1]
    c = kw["chunk"]
    tid = q_tid.long()
    active = ub0.amax(dim=1) > ts0[:, -1].clamp_min(0.0)
    n_active = int(active.sum())
    spans = int((tts[tid + 1] - tts[tid])[active].sum())
    flag0 = torch.zeros(1, dtype=torch.int32, device="cuda")

    def fresh():
        return ub0.clone(), flag0.clone()

    def kernel(ub, flag):
        br.round_select(ub, ts0, *rest, flag=flag, **kw)

    def library():
        torch.topk(ub0, c, dim=1)

    return {
        "ms": cuda_ms_fresh(kernel, fresh, queued=True),
        "launch_paced_ms": cuda_ms_fresh(kernel, fresh),
        "plain_ms": cuda_ms_fresh(
            lambda ub, flag: br.round_select_plain(ub, ts0, *rest, flag=flag, **kw), fresh
        ),
        **bound(
            4 * q * n_ranges + 4 * n_active * c + 4 * q + 4 * q * c + 8 * q * t * c
            + 12 * q * t + 4 * spans,
            q * n_ranges + n_active * t * c * max(1, int(kw["lmax"]).bit_length()),
        ),
        # The library's top-C over the same rows: no tie rule, no mask, no
        # threshold, no locate.
        "library_ms": device_ms(library),
        "library_launch_paced_ms": cuda_ms(library),
        "active_queries": n_active,
        "shape": {"Q": q, "T": t, "R": n_ranges, "C": c},
    }


def b1_check(engine, queries, label, phase, select_inputs=None):
    """Serve ``queries`` once through ``engine`` (a BlockMaxEngine on the
    card) with every B1 launch held against its plain version on the same
    inputs: ``torch.equal`` on every output and on every tensor updated in
    place, every round.  Then time each kernel, its plain version and the
    library call nearest to it on the first round's inputs (CUDA events; the
    in-place ones on fresh copies each call), and compute its bound from
    those inputs.  Returns {name: measured fields}; appends the first
    B1-select call's inputs to ``select_inputs`` where given."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br
    from vectorchord_bm25_tpu_torch.ops import topk
    from vectorchord_bm25_tpu_torch.search import blockmax

    st = {name: {"checked": 0, "err": 0.0, "first": None} for name in B1_NAMES}
    real = {name: getattr(blockmax, name) for name in B1_NAMES}

    def seen(name, first, err=0.0):
        c = st[name]
        c["checked"] += 1
        c["err"] = max(c["err"], err)
        if c["first"] is None:
            c["first"] = first

    def bounds(*a, **kw):
        out = real["range_bounds"](*a, **kw)
        want = br.range_bounds_plain(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{phase} range_bounds != its plain version")
        seen("range_bounds", (a, kw), float((out - want).abs().max()))
        return out

    def select(ub_work, topk_s, *rest, flag=None, **kw):
        first = (ub_work.clone(), topk_s.clone(), rest, kw)
        out = held_select(real["round_select"], phase, ub_work, topk_s, rest, flag, kw)
        seen("round_select", first)
        return out

    def merge(acc, cand_r, live, filt, topk_s, topk_d, **kw):
        ts, td = topk_s.clone(), topk_d.clone()
        inputs = (acc, cand_r, live, filt, ts.clone(), td.clone(), kw)
        out = real["round_merge"](acc, cand_r, live, filt, topk_s, topk_d, **kw)
        br.round_merge_plain(acc, cand_r, live, filt, ts, td, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(topk_s, ts) and torch.equal(topk_d, td)):
            raise AssertionError(f"{phase} round_merge != its plain version")
        seen("round_merge", inputs, _finite_err(topk_s, ts))
        st["round_merge"]["last"] = inputs
        return out

    for name, fn in zip(B1_NAMES, (bounds, select, merge)):
        setattr(blockmax, name, fn)
    try:
        engine.search(queries, K)
    finally:
        for name in B1_NAMES:
            setattr(blockmax, name, real[name])
    if not all(c["checked"] for c in st.values()):
        raise AssertionError(f"{phase} a B1 kernel saw no call: {st}")

    # B1-bounds: the query terms, their CSR spans ((range, ub) a group) and
    # the [Q, R] row written once; an add a group and a multiply a range.
    a, kw = st["range_bounds"]["first"]
    tts, _, _, q_tid = a
    n_ranges = kw["n_ranges"]
    q, t = q_tid.shape
    tid = q_tid.long()
    groups = int((tts[tid + 1] - tts[tid]).sum())
    out = {}
    out["range_bounds"] = {
        "ms": device_ms(lambda: br.range_bounds(*a, **kw)),
        "launch_paced_ms": cuda_ms(lambda: br.range_bounds(*a, **kw)),
        "plain_ms": cuda_ms(lambda: br.range_bounds_plain(*a, **kw)),
        **bound(12 * q * t + 8 * groups + 4 * q * n_ranges, groups + q * n_ranges),
        "library_ms": None,
    }
    ub0, ts0, rest, kw = st["round_select"]["first"]
    c = kw["chunk"]
    out["round_select"] = select_fields(ub0, ts0, rest, kw)
    n_active = out["round_select"]["active_queries"]
    if select_inputs is not None:
        select_inputs.append(st["round_select"]["first"])
    out["round_merge"] = b1_merge_fields(st["round_merge"]["first"])
    out["round_merge"]["later_round"] = b1_merge_fields(st["round_merge"]["last"])
    out["round_merge"]["later_round"]["round"] = st["round_merge"]["checked"]
    rs, k = out["round_merge"]["shape"]["RS"], out["round_merge"]["shape"]["k"]
    scored = out["round_merge"]["scored_lanes"]
    for name in B1_NAMES:
        out[name]["max_abs_err"] = st[name]["err"]
        out[name]["checked"] = st[name]["checked"]
    print(
        f"{phase} B1 == plain (torch.equal) on every call: bounds "
        f"{st['range_bounds']['checked']}, select {st['round_select']['checked']}, "
        f"merge {st['round_merge']['checked']}; Q,T,C,RS,R,k="
        f"{(q, t, c, rs, n_ranges, k)}, {groups} groups, {n_active} active "
        f"queries and {scored} scored lanes in round 1 [{label}]"
    )
    for name in B1_NAMES:
        m = out[name]
        lib = "none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"
        print(
            f"{phase} {name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
            f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}, {m['bound_bytes']} B), "
            f"library {lib} [{label}]"
        )
    print(
        f"{phase} range_bounds launched back to back: kernel "
        f"{out['range_bounds']['launch_paced_ms']:.4f} ms (the line above: device time) "
        f"[{label}]"
    )
    m = out["round_select"]
    print(
        f"{phase} round_select launched back to back: kernel {m['launch_paced_ms']:.4f} "
        f"ms, torch.topk {m['library_launch_paced_ms']:.4f} ms (the lines above: "
        f"device time, launches queued behind a sleeping kernel) [{label}]"
    )
    for what, m in (("round 1", out["round_merge"]),
                    (f"round {out['round_merge']['later_round']['round']} (the last)",
                     out["round_merge"]["later_round"])):
        print(
            f"{phase} round_merge {what}: kernel {m['ms']:.4f} ms device, "
            f"{m['launch_paced_ms']:.4f} back to back; plain {m['plain_ms']:.4f} ms; bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}, {m['bound_bytes']} B); torch.topk on "
            f"the packed keys {m['library_ms']:.4f} ms; {m['scored_lanes']} scored lanes, "
            f"{m['all_zero_share']:.4f} of {m['shape']['Q']} queries all-zero (Q,C,RS,k="
            f"{tuple(m['shape'].values())}) [{label}]"
        )
    return out


def b1_merge_fields(inputs):
    """B1-merge timed on one call's inputs (a fresh top-k each launch): the
    kernel on the card (launches queued behind a sleeping kernel) and back
    to back, its plain version, ``torch.topk`` on the same candidates
    already masked and packed, and its bound: the [Q, C, RS] scores read
    once, cand_r, the live and filter entries of the lanes that scored, the
    top-k read and written; two multiplies and a compare a lane that
    scored.  ``all_zero_share``: the queries none of whose lanes can score
    (+-0 or NaN everywhere), which the kernel leaves at once."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import blockmax_round as br
    from vectorchord_bm25_tpu_torch.ops import topk

    acc, cand_r, live, filt, ts1, td1, kw = inputs
    n_docs = kw["n_docs"]
    q, c, rs = acc.shape
    k = ts1.shape[1]
    scored = int((acc > 0).sum())
    can = (acc != 0) & ~acc.isnan()
    all_zero = float((~can.reshape(q, -1).any(dim=1)).float().mean())
    del can
    docs = cand_r[:, :, None] * rs + torch.arange(rs, dtype=torch.int32, device="cuda")
    dc = docs.clamp_max(n_docs).long()
    masked = acc * live[dc] * filt[dc]
    ok = (masked > 0) & (docs < n_docs)
    keys = torch.cat(
        [
            topk._pack(ts1, td1),
            topk._pack(
                torch.where(ok, masked, float("-inf")).reshape(q, -1),
                torch.where(ok, docs, 2**31 - 1).reshape(q, -1),
            ),
        ],
        dim=1,
    )
    del docs, dc, masked, ok

    def fresh_topk():
        return ts1.clone(), td1.clone()

    def kernel(s, d):
        br.round_merge(acc, cand_r, live, filt, s, d, **kw)

    fields = {
        "ms": cuda_ms_fresh(kernel, fresh_topk, queued=True),
        "launch_paced_ms": cuda_ms_fresh(kernel, fresh_topk),
        "plain_ms": cuda_ms_fresh(
            lambda s, d: br.round_merge_plain(acc, cand_r, live, filt, s, d, **kw),
            fresh_topk, iters=10,
        ),
        **bound(4 * acc.numel() + 4 * cand_r.numel() + 8 * scored + 16 * q * k, 3 * scored),
        # The library's selection over the same packed keys, already masked
        # and packed: it does neither.
        "library_ms": device_ms(lambda: torch.topk(keys, k, dim=1, largest=False)),
        "scored_lanes": scored,
        "all_zero_share": all_zero,
        "shape": {"Q": q, "C": c, "RS": rs, "k": k},
    }
    del keys
    return fields


def device_profile(fn, what, label, track=(), expect=None, tries=3):
    """One call of ``fn`` under ``torch.profiler``: the card's busy time, its
    share of the call's wall time, and the kernels by device time; each
    kernel whose name holds a string of ``track`` is named on its own.
    Busy time sums the device's own rows (kernels, copies, fills): an
    operator row (``aten::copy_``, ``aten::zero_``) carries the device time
    of the kernels it launched, which its kernel rows count already.  The
    sum over every row, which counts those twice, is printed beside it.
    ``fn`` runs twice, once as the profiler's warm-up step, whose events
    are dropped, then as the recorded step: the tracer drops kernels of a
    call that begins as it starts.  ``expect`` maps tracked strings to
    their wrappers' launch counters: a profile whose rows count fewer or
    more launches than a counter grew by over the recorded call is
    incomplete, is taken again, up to ``tries`` times, and raises after
    that.  Returns the wall and busy ms and each tracked
    string's device ms and launches (None if the profiler saw no device
    time and nothing was expected)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    expect = expect or {}
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = {name: count() for name, count in expect.items()}
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            made = {name: count() - before[name] for name, count in expect.items()}
            prof.step()
        rows, every_ms = [], 0.0
        for e in prof.key_averages():
            if e.key.startswith("ProfilerStep") or getattr(e, "is_user_annotation", False):
                continue  # the schedule's step and the program's spans, not device work
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            every_ms += us / 1e3
            if us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
                rows.append((us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        seen = {
            name: sum(n for _, n, key in rows if name in key) for name in set(track) | set(expect)
        }
        missed = {name: (seen[name], n) for name, n in made.items() if seen[name] != n}
        if not missed:
            break
        print(
            f"{what}: profile {attempt} incomplete, (rows, launches) {missed}"
            + ("; profiling again" if attempt < tries else "")
        )
    else:
        raise AssertionError(f"{what}: {tries} profiles missed launches: {missed}")
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print(f"{what}: the profiler saw no device time")
        return None
    print(
        f"{what}: one profiled batch {wall_ms:.3f} ms, the card busy {busy_ms:.3f} "
        f"ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle; {every_ms:.3f} ms with the "
        f"operator rows counted too); by kernel: "
        + "; ".join(f"{key[:48]} {ms:.3f} ms x{n}" for ms, n, key in rows[:8])
        + (f"; every launch of {sorted(made)} in the rows ({made})" if made else "")
        + f" [{label}]"
    )
    tracked = {}
    for name in track:
        hit = [(ms, n, key) for ms, n, key in rows if name in key]
        tracked[name] = {"ms": sum(h[0] for h in hit), "launches": sum(h[1] for h in hit)}
        print(
            f"{what}: {name}: "
            + ("; ".join(f"{key[:64]} {ms:.3f} ms x{n}" for ms, n, key in hit) or "no row")
            + f" in the batch [{label}]"
        )
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "every_row_ms": every_ms, "tracked": tracked}


@contextlib.contextmanager
def host_timed(module, names):
    """Times every call of ``module``'s functions ``names`` on the host
    (perf_counter) while the block runs: yields {name: [seconds, calls]}."""
    real = {name: getattr(module, name) for name in names}
    spent = {name: [0.0, 0] for name in names}

    def timed(name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1

        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield spent
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def planning_host_ms(fn, module, what, label):
    """One call of ``fn`` with the sparse kernels' host planning timed:
    ``doc_ordered`` (MaxScore's prefixes put in doc order) and
    ``segment_offsets`` (each row's segments), beside the call's wall
    time.  Returns {name: (ms, calls)} and the wall ms."""
    with host_timed(module, ("doc_ordered", "segment_offsets")) as spent:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    got = {name: (sec * 1e3, n) for name, (sec, n) in spent.items()}
    print(
        f"{what}: host time of the sparse planning in one batch of {wall_ms:.3f} ms: "
        + ", ".join(f"{name} {ms:.3f} ms in {n} calls" for name, (ms, n) in got.items())
        + f" [{label}]"
    )
    return got, wall_ms


def rounds_equal(gpu_engine, cpu_engine, sample, what):
    """``last_rounds`` of the card's engine equals the CPU-plain engine's on
    the same queries (and so do the results); every B1-select call of the
    card's batch is held to its plain version."""
    with select_held(what) as calls:
        got = gpu_engine.search(sample, K)
    if len(calls) < gpu_engine.last_rounds:
        raise AssertionError(f"{what}: {len(calls)} B1-select calls held, {gpu_engine.last_rounds} rounds")
    print(
        f"{what}: all {len(calls)} B1-select calls of the card's batch == "
        f"round_select_plain (torch.equal, four outputs and the row)"
    )
    want = cpu_engine.search(sample, K)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: GPU != CPU-plain")
    if gpu_engine.last_rounds != cpu_engine.last_rounds:
        raise AssertionError(
            f"{what}: last_rounds {gpu_engine.last_rounds} on the card, "
            f"{cpu_engine.last_rounds} on the CPU"
        )
    return gpu_engine.last_rounds


def dir_bytes(path):
    import os

    return sum(
        os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(path) for f in files
    )


def restart(index, queries, new_docs, label, what):
    """Phase (t): ``index`` (live, on the card) survives a restart.  (1)
    save, open: one batch equals the live index's, scores bit for bit; (2)
    through the opened index insert ``new_docs`` and delete another 1% of
    the sealed docs with no checkpoint, drop it, open again: the WAL
    replays and the batch equals the live index's after the same mutations;
    (3) maintain, save, open: the WAL is empty, one generation is left,
    results equal.  Every time printed is a host time."""
    import os
    import tempfile

    import torch

    from vectorchord_bm25_tpu_torch import open_index, save_index
    from vectorchord_bm25_tpu_torch.native import loader

    if not loader.available():
        raise AssertionError(f"(t) the native codecs did not load: {loader.BUILD_ERROR}")

    def doomed_too(p):
        return (np.asarray(p) * 2654435761) % 100 == 1

    def clock(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def opened_index(path):
        opened, sec = clock(open_index, path, device="cuda")
        engine, sec_engine = clock(opened.engine)
        if not opened.device.type == "cuda" or type(engine) is not type(index.engine()):
            raise AssertionError(f"(t) {what}: opened {engine!r} on {opened.device}")
        return opened, sec, sec_engine

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "idx")
        _, times["save 1"] = clock(save_index, index, path)
        size_1 = dir_bytes(path)
        opened, times["open 1"], times["engine 1"] = opened_index(path)
        want = hits_of(index.search_batch(queries, K))
        if hits_of(opened.search_batch(queries, K)) != want:
            raise AssertionError(f"(t) {what}: the opened index != the live index")
        n_hits = sum(map(len, want))

        base = int(max(index.sealed.doc_payload.max(), max(index.growing.payloads, default=0))) + 1
        t0 = time.perf_counter()
        for j, doc in enumerate(new_docs):
            opened.insert(doc, base + j)
        n_del = opened.bulkdelete(doomed_too)
        times[f"{len(new_docs)} inserts + 1 delete, each fsynced"] = time.perf_counter() - t0
        for j, doc in enumerate(new_docs):
            index.insert(doc, base + j)
        if index.bulkdelete(doomed_too) != n_del or not n_del:
            raise AssertionError(f"(t) {what}: bulkdelete counts differ or deleted nothing")
        wal_bytes = os.path.getsize(os.path.join(path, "wal.log"))
        opened._wal.close()
        del opened
        again, times["open 2 (WAL replay)"], times["engine 2"] = opened_index(path)
        want = hits_of(index.search_batch(queries, K))
        got = hits_of(again.search_batch(queries, K))
        if got != want or len(again.growing) != len(index.growing):
            raise AssertionError(f"(t) {what}: after the WAL replay != the live index")
        n_grow = sum(p >= base for hits in got for _, p in hits)
        if any(doomed_too(p) for hits in got for _, p in hits):
            raise AssertionError(f"(t) {what}: a deleted payload came back")

        _, times["maintain"] = clock(again.maintain)
        want = hits_of(again.search_batch(queries, K))
        _, times["save 2"] = clock(save_index, again, path)
        gens = [n for n in os.listdir(path) if n.startswith("gen-")]
        if os.path.getsize(os.path.join(path, "wal.log")) or len(gens) != 1:
            raise AssertionError(f"(t) {what}: WAL not empty or generations {gens}")
        size_2 = dir_bytes(path)
        again._wal.close()
        third, times["open 3"], times["engine 3"] = opened_index(path)
        if hits_of(third.search_batch(queries, K)) != want or len(third.growing):
            raise AssertionError(f"(t) {what}: after maintain + save != before")
        third._wal.close()
    print(
        f"(t) {what}: (1) save + open: {len(queries)} queries == the live index "
        f"({n_hits} hits, scores bit for bit), {size_1} B on disk; (2) "
        f"{len(new_docs)} inserts and {n_del} deletes through the WAL "
        f"({wal_bytes} B), no checkpoint, reopened: == the live index, "
        f"{n_grow} growing hits; (3) maintain + save + open: wal.log empty, "
        f"generations {gens}, {size_2} B on disk, results equal"
    )
    print(
        f"(t) {what} host times: "
        + "; ".join(f"{name} {sec:.2f} s" for name, sec in times.items())
        + f" [{label}]"
    )
    print(
        f"(t) {what} at {index.sealed.n_docs} docs on the native codecs: save "
        f"{times['save 1']:.2f} s, open {times['open 1']:.2f} s (the numpy codecs, "
        f"PERF.md: save 3.72-5.96 s, open 2.26-3.54 s) [{label}]"
    )
    return times


def stream_slice(args, seg, seed, queries, keys, tfs, doc_start, label, build_times):
    """Phases (f)-(h): the served default engine with a growing segment.
    Returns the kernels-line entries of S1 and S2, and the engine's
    ``memory_parity_report`` (phase (y) prints it)."""
    import torch

    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        Document,
        IndexOptions,
    )
    from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk
    from vectorchord_bm25_tpu_torch.search import stream as port_stream
    from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup
    from vectorchord_bm25_tpu_torch.utils.memparity import memory_parity_report

    # (f) the served default on the card
    t0 = time.perf_counter()
    index = Bm25Index(seg, seed, IndexOptions(), device="cuda")
    engine = index.engine()
    si = engine.stream
    if index.engine_kind != "stream" or type(engine) is not port_stream.StreamEngine:
        raise AssertionError(f"default engine is {index.engine_kind}: {engine!r}")
    build_times["(f) stream index"] = time.perf_counter() - t0
    parity = memory_parity_report(engine, seg)
    print(
        f"(f) stream index: {si.n_windows} windows, {si.n_postings} postings, "
        f"{si.words.nbytes} B of stream words; host build "
        f"{build_times['(f) stream index']:.1f} s; device index "
        f"{engine.memory_report()['total']} B"
    )
    dispatches = []
    launch = port_stream.stream_dense_accumulate

    def record(*a):
        dispatches.append(a)
        return launch(*a)

    port_stream.stream_dense_accumulate = record
    try:
        engine.search(queries, K)
    finally:
        port_stream.stream_dense_accumulate = launch
    kk = min(1 << (K - 1).bit_length(), seg.n_docs)
    s1_err = s2_err = 0.0
    for a in dispatches:
        if not stream_kernel.stream_spans_in_layout(a[6], a[7], a[8], a[3]).all():
            raise AssertionError("(f) a dispatch's spans are off the planning's layout")
        got = stream_kernel.stream_dense_accumulate(*a)
        want = stream_kernel.stream_dense_accumulate_plain(*a)
        torch.cuda.synchronize()
        s1_err = max(s1_err, float((got - want).abs().max()))
        # The padded rows too: the kernel writes every cell itself.
        if not torch.equal(got, want) or not torch.equal(rows_whole(got), rows_whole(want)):
            raise AssertionError(f"S1 != plain on a dispatch: max abs err {s1_err}")
        del want
        ks, ki = topk.dense_topk(got, kk, seg.n_docs)
        ps, pi = topk.dense_topk_plain(got, kk, seg.n_docs)
        torch.cuda.synchronize()
        live = torch.isfinite(ps)
        s2_err = max(s2_err, float(torch.where(live, ks - ps, 0.0).abs().max()))
        if not (torch.equal(ks, ps) and torch.equal(ki, pi)):
            raise AssertionError("S2 != plain on a dispatch")
        print(
            f"(f) dispatch [{a[-2]} rows, {a[6].numel()} windows, "
            f"{int(a[8].max()) + 1} ordinals, {int((got > 0).sum())} nonzero "
            f"accumulator cells]: spans on the layout; S1 == plain, its padded rows "
            f"included, S2 == plain (torch.equal)"
        )
        del got
    a = dispatches[0]
    n_q, n_docs = a[-2], a[-1]

    def s1():
        return stream_kernel.stream_dense_accumulate(*a)

    s1_ms = device_ms(s1, iters=10)
    s1_paced_ms = cuda_ms(s1, iters=10)
    s1_tiles = tile_sweep(s1)
    s1_plain_ms = cuda_ms(lambda: stream_kernel.stream_dense_accumulate_plain(*a), iters=5)
    # The zero-fill the first design ran before its launches, alone.
    zero_ms = device_ms(lambda: topk.new_accumulator(n_q, n_docs, "cuda"), iters=10)
    acc = stream_kernel.stream_dense_accumulate(*a)
    s2 = s2_fields(acc, kk, n_docs)
    s2_ms, s2_plain_ms, s2_lib_ms = s2["ms"], s2["plain_ms"], s2["library_ms"]
    del acc
    pad_rows = s2_pads_check(n_q, n_docs, kk, args.seed + 12)
    # S1 must read each window's words and meta and write the accumulator;
    # S2 must read the accumulator's doc columns.
    n_words, lanes, n_win = window_words(si, a[6].cpu().numpy())
    s1_bound = bound(
        4 * n_words + 14 * n_win + 8 * a[6].numel() + 4 * a[7].numel()
        + 4 * min(lanes, n_docs + 1) + 4 * n_q * (n_docs + 1),
        4 * lanes,
    )
    s2_bound = {key: s2[key] for key in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")}
    print(
        f"(f) S1 doc tiles on the first dispatch, device ms by tile (cells): "
        + ", ".join(f"{t} {ms:.4f}" for t, ms in s1_tiles.items()) + f" [{label}]"
    )
    print(
        f"(f) {len(dispatches)} dispatches; first: n_q={n_q}, N+1={n_docs + 1}, "
        f"{a[6].numel()} windows; S1 {s1_ms:.4f} ms on the card ({s1_paced_ms:.4f} "
        f"back to back; one launch, every cell written, no zero-fill) vs plain "
        f"{s1_plain_ms:.4f} ms (with its zero-fill); the old torch.zeros fill alone "
        f"{zero_ms:.4f} ms; S2 "
        f"{s2_ms:.4f} ms on the card ({s2['launch_paced_ms']:.4f} back to back) vs "
        f"plain {s2_plain_ms:.4f} ms at k={kk}, torch.topk "
        f"{s2_lib_ms:.4f} ms; bounds S1 {s1_bound['bound_ms']:.4f} ms, S2 "
        f"{s2_bound['bound_ms']:.4f} ms [{label}]"
    )
    print(
        f"(f) S2 on {pad_rows} rows with 0 to {kk - 1} positive docs (hierarchical at "
        f"{n_docs} docs and flat at 16384): scores and every id, the pads' included, "
        f"== plain (torch.equal)"
    )
    index.search_batch(queries, K)  # warm-up
    torch.cuda.synchronize()
    stream_kernel.LAUNCHES = topk.LAUNCHES = 0
    qps = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        results = index.search_batch(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
    s1_launches, s2_launches = stream_kernel.LAUNCHES, topk.LAUNCHES
    if not s1_launches or not s2_launches:
        raise AssertionError(
            f"the default engine launched S1 {s1_launches}, S2 {s2_launches} times"
        )
    if len(results) != len(queries) or not all(
        np.isfinite(h.score) and h.score > 0 for hits in results for h in hits
    ):
        raise AssertionError("stream results are not finite positive hits")
    print(
        f"(f) served default: {ROUNDS} x search_batch({len(queries)} queries, "
        f"k={K}); S1 {s1_launches} launches, S2 {s2_launches}; QPS per batch "
        f"{[round(x, 1) for x in qps]} (median {float(np.median(qps)):.1f}) [{label}]"
    )
    prof = device_profile(
        lambda: index.search_batch(queries, K), "(f) profile", label,
        track=("block_max_keys", "dense_topk_select", "dense_tiles_kernel", "FillFunctor"),
    )
    s2_profile = None
    if prof is not None:
        s2_ms_batch = prof["tracked"]["block_max_keys"]["ms"] + prof["tracked"]["dense_topk_select"]["ms"]
        s2_profile = {
            "ms": s2_ms_batch,
            "busy_ms": prof["busy_ms"],
            "wall_ms": prof["wall_ms"],
            "every_row_ms": prof["every_row_ms"],
            "share_of_busy": s2_ms_batch / prof["busy_ms"],
            "launches": prof["tracked"]["dense_topk_select"]["launches"],
            "s1_ms": prof["tracked"]["dense_tiles_kernel"]["ms"],
            "s1_launches": prof["tracked"]["dense_tiles_kernel"]["launches"],
            "fill_ms": prof["tracked"]["FillFunctor"]["ms"],
        }
        print(
            f"(f) profile: S2 (block_max_keys + dense_topk_select_kernel) {s2_ms_batch:.3f} ms of "
            f"{prof['busy_ms']:.3f} ms busy ({100 * s2_profile['share_of_busy']:.1f}%) "
            f"in one batch [{label}]"
        )

    # (g) correctness at that size
    rng = np.random.default_rng(args.seed + 3)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    cpu = Bm25Index(seg, seed, IndexOptions(), device="cpu")
    want_bytes = si.words.nbytes + 4 * (si.n_docs + 1) + 14 * (si.n_windows + 1)
    got_bytes = engine.memory_report()["total"]
    if got_bytes != want_bytes:
        raise AssertionError(f"memory_report total {got_bytes} != {want_bytes}")
    recall, total, ties, n_del = audit(index, cpu, seg, sample)
    print(
        f"(g) {AUDIT} sampled queries: GPU == CPU-plain, also after deleting "
        f"{n_del} docs (1%) and with a prefilter; recall@{K} vs the float64 "
        f"oracle {recall} ({total} hits, {ties} boundary ties excused); "
        f"memory_report total {got_bytes} B == stream host arrays"
    )

    # (h) a growing segment served on the card
    picks = rng.choice(seg.n_docs, 1024, replace=False)
    base = int(seg.doc_payload.max()) + 1
    for j, d in enumerate(picks):
        lo, hi = int(doc_start[d]), int(doc_start[d + 1])
        doc = Document(keys=keys[lo:hi], values=tfs[lo:hi])
        index.insert(doc, base + j)
        cpu.insert(doc, base + j)
    restore, grow_st = _checked(
        port_stream, "stream_dense_accumulate", stream_kernel.stream_dense_accumulate_plain,
        lambda a: a[6].numel(), _finite_err,
    )
    looked_up = batch_lookup(index.sealed.lookup_tokens, sample)
    try:
        index.growing.topk_batch_async(*looked_up, len(sample), K, None)()  # every S1 call held to plain
    finally:
        restore()
    stream_kernel.LAUNCHES = 0
    index.growing.topk_batch_async(*looked_up, len(sample), K, None)()
    grow_launches = stream_kernel.LAUNCHES
    g_engine = index.growing.device_engine()
    if not grow_launches or not grow_st["checked"] or not g_engine.dev_words.is_cuda:
        raise AssertionError("the growing segment was not served by S1 on the card")
    got = hits_of(index.search_batch(sample, K))
    if got != hits_of(cpu.search_batch(sample, K)):
        raise AssertionError("growing: GPU != CPU-plain")
    n_new = sum(p >= base for hits in got for _, p in hits)
    print(
        f"(h) {len(index.growing)} growing docs ({g_engine.n_docs} in the card "
        f"engine, {g_engine.stream.n_windows} windows): GPU == CPU-plain on "
        f"{AUDIT} queries, {n_new} growing hits; growing engine S1 launches "
        f"{grow_launches}, {grow_st['checked']} calls == plain (torch.equal)"
    )
    # (t) this index, with its deletes and its growing segment, restarted
    picks = rng.choice(seg.n_docs, 1024, replace=False)
    new_docs = [
        Document(
            keys=keys[int(doc_start[d]) : int(doc_start[d + 1])],
            values=tfs[int(doc_start[d]) : int(doc_start[d + 1])],
        )
        for d in picks
    ]
    t0 = time.perf_counter()
    restart(index, queries, new_docs, label, "served default (stream)")
    build_times["(t) stream"] = time.perf_counter() - t0
    return [
        {
            "name": "stream_dense_accumulate",
            "route": "cuda",
            "source": "vectorchord_bm25_tpu_torch/csrc/stream_dense.cu",
            "replaces": "vectorchord_bm25_tpu/search/stream.py:171",
            "launches": s1_launches,
            "launches_growing": grow_launches,
            "max_abs_err": max(s1_err, grow_st["err"]),
            "ms": s1_ms,
            "launch_paced_ms": s1_paced_ms,
            "tile_ms": s1_tiles,
            "old_fill_ms": zero_ms,
            "plain_ms": s1_plain_ms,
            **s1_bound,
            "library_ms": None,
        },
        {
            "name": "dense_topk",
            "route": "cuda",
            "source": "vectorchord_bm25_tpu_torch/csrc/dense_topk.cu",
            "replaces": "vectorchord_bm25_tpu/ops/topk.py:31",
            "launches": s2_launches,
            "max_abs_err": s2_err,
            "ms": s2_ms,
            "plain_ms": s2_plain_ms,
            **s2_bound,
            "library_ms": s2_lib_ms,
            "launch_paced_ms": s2["launch_paced_ms"],
            "shape": s2["shape"],
            "pad_rows_checked": pad_rows,
            "profile_f": s2_profile,
        },
    ], parity


def _record(module, name):
    """Replace ``module.name`` by a pass-through that keeps the arguments
    of every call (the engine never writes to them afterwards; an ``out``
    is dropped, so a replay returns a fresh result).  Returns (restore,
    calls)."""
    real = getattr(module, name)
    calls = []

    def record(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != "out"}))
        return real(*args, **kw)

    setattr(module, name, record)
    return (lambda: setattr(module, name, real)), calls


def _kernel_vs_plain(kernel, plain, calls, what):
    """Every recorded call's kernel result ``torch.equal`` to its plain
    version; returns the max abs error and (kernel ms, plain ms) on the
    first call."""
    import torch

    err = 0.0
    for args, kw in calls:
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{what} != its plain version")
        err = max(err, _finite_err(*pairs[0]))
    args, kw = calls[0]
    return err, cuda_ms(lambda: kernel(*args, **kw)), cuda_ms(lambda: plain(*args, **kw))


def _serve(index, queries, counters, what, rounds=ROUNDS):
    """Warm up, zero the launch counters, serve ``rounds`` batches and read
    the counters: (module, name) pairs, or (module, name, key) where two
    modules share a name.  Returns (QPS per batch, launches by name or key,
    results)."""
    import torch

    index.search_batch(queries, K)
    torch.cuda.synchronize()
    for module, name, *_ in counters:
        setattr(module, name, 0)
    qps = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        results = index.search_batch(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
    launches = {
        (key[0] if key else name): getattr(module, name)
        for module, name, *key in counters
    }
    if not all(launches.values()):
        raise AssertionError(f"{what}: a kernel of the path never launched: {launches}")
    if len(results) != len(queries) or not all(
        np.isfinite(h.score) and h.score > 0 for hits in results for h in hits
    ):
        raise AssertionError(f"{what}: results are not finite positive hits")
    return qps, launches, results


def blockmax_rest(args, seg, seed, queries, ri, f32_engine, f32_cpu, label):
    """Phases (l)-(n): the rest of the Block-Max engine on the 131,072-doc
    corpus and its RangeIndex.  Returns the kernels-line entries of P1 on
    bf16 and P1-tf, the rangescan's P1 and S2 launch counts, and B1's
    launches by phase."""
    import torch

    from vectorchord_bm25_tpu_torch import Bm25Index, IndexOptions
    from vectorchord_bm25_tpu_torch.ops import score_kernel, topk
    from vectorchord_bm25_tpu_torch.search import blockmax
    from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine

    rng = np.random.default_rng(args.seed + 5)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    n, v, p = seg.n_docs, seg.n_tokens, ri.post_local.size
    meta = 12 * (ri.tr_range.size + 1) + 4 + 4 * (v + 2)  # range meta + CSR

    def build(opts, device):
        return Bm25Index(
            seg, seed, IndexOptions(), engine="blockmax",
            engine_options={**opts, "range_index": ri}, device=device,
        )

    f32_fresh = BlockMaxEngine(seg, ri, device="cuda")  # bf16's yardstick, no deletes
    entries = []
    b1_by_phase = {}
    for phase, mode, opts in (
        ("(l)", "bf16", {"impact_dtype": "bfloat16"}),
        ("(m)", "tf", {"posting_mode": "tf"}),
    ):
        index = build(opts, "cuda")
        engine = index.engine()
        name = "fused_range_scores" if mode == "bf16" else "tf_range_scores"
        counter = "BF16_LAUNCHES" if mode == "bf16" else "TF_LAUNCHES"
        restore, calls = _record(blockmax, name)
        try:
            engine.search(queries, K)
        finally:
            restore()
        kernel = getattr(score_kernel, name)
        err, ms, plain_ms = _kernel_vs_plain(
            kernel, getattr(score_kernel, name + "_plain"), calls, f"P1 {mode}"
        )
        first = calls[0][0]
        post = first[0]
        starts, lens = (first[2], first[3]) if mode == "bf16" else (first[6], first[7])
        rs = calls[0][1]["rs"]
        kb = p1_bound(post, starts, lens, rs)
        print(
            f"{phase} {mode}: {len(calls)} rounds, kernel == plain on every "
            f"round's windows (torch.equal); Q,T,C,RS={(*starts.shape, rs)}, "
            f"{int(lens.sum())} active lanes in round 1: kernel {ms:.4f} ms "
            f"(back to back), plain {plain_ms:.4f} ms, bound {kb['bound_ms']:.4f} ms "
            f"({kb['bound_by']}) [{label}]"
        )
        tf_rounds = {}
        if mode == "tf":
            # P1-tf on the card alone, round 1 and the batch's last round.
            for key, (a, kw) in (("round_1", calls[0]), ("last_round", calls[-1])):
                tf_rounds[key] = tf_fields(a, kw)
                tf_rounds[key]["round"] = 1 if key == "round_1" else len(calls)
            ms = tf_rounds["round_1"]["ms"]
            for key, f in tf_rounds.items():
                print(
                    f"{phase} P1-tf round {f['round']}"
                    f"{' (the last)' if key == 'last_round' else ''}: kernel "
                    f"{f['ms']:.4f} ms on the card ({f['launch_paced_ms']:.4f} back to "
                    f"back), plain {f['plain_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
                    f"({f['bound_bytes']} B); {f['active_lanes']} active lanes, "
                    f"{f['inactive_queries']:.4f} of queries with no window [{label}]"
                )
        del calls
        b1_check(engine, queries, label, phase)
        qps, launches, _ = _serve(
            index, queries, [(score_kernel, counter), *b1_counters()], mode
        )
        b1_by_phase[phase] = {name: launches[name] for name in B1_NAMES}
        print(
            f"{phase} {mode}: {ROUNDS} x search_batch({len(queries)} queries, "
            f"k={K}); {launches[counter]} kernel launches, B1 "
            f"{b1_by_phase[phase]}; QPS per batch "
            f"{[round(x, 1) for x in qps]} (median {float(np.median(qps)):.1f}) [{label}]"
        )
        if mode == "tf":
            # P1-tf's share of one batch (its kernel is P1's walk with the
            # tf scorer).
            prof = device_profile(
                lambda: index.search_batch(queries, K), f"{phase} profile", label,
                track=("TfScorer",),
            )
            if prof is not None:
                tf_rounds["profile"] = {
                    **prof["tracked"]["TfScorer"], "busy_ms": prof["busy_ms"],
                    "wall_ms": prof["wall_ms"],
                }
        # Device bytes by the reference's formula (search/blockmax.py:475-507).
        if mode == "bf16":
            want_bytes = 3 * p + meta + 4 * (n + 1)
        else:
            tf_bytes = engine.dev_post_tf.element_size()
            want_bytes = (tf_bytes + 1) * p + meta + 5 * (n + 1)
        got_bytes = engine.memory_report()["total"]
        if got_bytes != want_bytes:
            raise AssertionError(f"{mode} memory_report total {got_bytes} != {want_bytes}")
        cpu = build(opts, "cpu")
        if mode == "bf16":
            got = index.search_batch(sample, K)
            if hits_of(got) != hits_of(cpu.search_batch(sample, K)):
                raise AssertionError("bf16: GPU != CPU-plain")
            n_rounds = rounds_equal(engine, cpu.engine(), sample, "bf16")
            s_bf, i_bf, _ = engine.search(queries, K)
            s_32, i_32, _ = f32_fresh.search(queries, K)
            if not np.array_equal(i_bf >= 0, i_32 >= 0):
                raise AssertionError("bf16 and f32 return different hit counts")
            live = i_32 >= 0
            np.testing.assert_allclose(s_bf[live], s_32[live], rtol=6e-3)
            hit = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(i_bf, i_32))
            recall = hit / max(1, int(live.sum()))
            print(
                f"{phase} bf16: GPU == CPU-plain on {AUDIT} queries (last_rounds "
                f"{n_rounds} on both); scores per "
                f"rank within rtol 6e-3 of the f32 engine's on {len(queries)} "
                f"queries, recall@{K} vs the f32 engine {recall:.6f}; "
                f"memory_report total {got_bytes} B == the reference's formula"
            )
        else:
            recall, total, ties, n_del = audit(index, cpu, seg, sample)
            n_rounds = rounds_equal(index.engine(), cpu.engine(), sample, "tf")
            print(
                f"{phase} tf: {AUDIT} sampled queries: GPU == CPU-plain (last_rounds "
                f"{n_rounds} on both after the deletes), also "
                f"after deleting {n_del} docs (1%) and with a prefilter; recall@{K} "
                f"vs the float64 oracle {recall} ({total} hits, {ties} ties excused); "
                f"post_tf {engine.dev_post_tf.dtype}; memory_report total "
                f"{got_bytes} B == the reference's formula"
            )
        entries.append(
            {
                "name": "fused_range_scores_bf16" if mode == "bf16" else "tf_range_scores",
                "route": "cuda",
                "source": "vectorchord_bm25_tpu_torch/csrc/"
                + ("score_kernel.cu" if mode == "bf16" else "tf_range_scores.cu"),
                "replaces": "vectorchord_bm25_tpu/ops/score_kernel.py:67"
                if mode == "bf16"
                else "vectorchord_bm25_tpu/search/blockmax.py:169",
                "launches": launches[counter],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                **kb,
                "library_ms": None,
                **({"last_round": tf_rounds["last_round"],
                    "launch_paced_ms": tf_rounds["round_1"]["launch_paced_ms"],
                    "profile": tf_rounds.get("profile")}
                   if tf_rounds else {}),
            }
        )
        del index, engine, cpu

    # (n) the exhaustive sweep on the f32 engine: P1 per chunk, then S2
    restores = [_record(blockmax, "fused_range_scores"), _record(blockmax, "dense_topk")]
    try:
        swept = f32_engine.search_rangescan_async(queries, K)()
    finally:
        for restore, _ in restores:
            restore()
    p1_calls, s2_calls = (calls for _, calls in restores)
    p1_err, p1_ms, p1_plain_ms = _kernel_vs_plain(
        score_kernel.fused_range_scores, score_kernel.fused_range_scores_plain,
        p1_calls, "P1 in the sweep",
    )
    s2_err, s2_ms, s2_plain_ms = _kernel_vs_plain(
        topk.dense_topk, topk.dense_topk_plain, s2_calls, "S2 in the sweep"
    )
    (post, loc, starts, lens), rs = p1_calls[0][0], p1_calls[0][1]["rs"]
    acc, kk, n_docs = s2_calls[0][0]
    q = acc.shape[0]
    # P1 as the sweep launches it: a chunk written at the accumulator's row
    # stride into its columns.
    width = len(p1_calls) * starts.shape[2] * rs
    wide = torch.empty((q, (width + 3) & ~3), dtype=torch.float32, device="cuda")
    strided = p1_fields(post, loc, starts, lens, rs, out=wide[:, : starts.shape[2] * rs])
    del wide
    sweep = {
        "fused_range_scores": {
            "sweep_ms": p1_ms, "sweep_plain_ms": p1_plain_ms,
            "sweep_bound_ms": p1_bound(post, starts, lens, rs)["bound_ms"],
            "sweep_strided": strided,
        },
        "dense_topk": {
            "sweep_ms": s2_ms, "sweep_plain_ms": s2_plain_ms,
            "sweep_bound_ms": bound(4 * q * n_docs + 8 * q * kk, q * n_docs)["bound_ms"],
            "sweep_library_ms": cuda_ms(lambda: torch.topk(acc[:, :n_docs], kk, dim=1), iters=5),
            "sweep_shape": {"Q": q, "M": acc.shape[1], "n_docs": n_docs, "k": kk},
        },
    }
    print(
        f"(n) rangescan: {len(p1_calls)} chunks of Q,T,C,RS="
        f"{(*starts.shape, rs)} into a {tuple(acc.shape)} accumulator; P1 == "
        f"plain on every chunk, S2 == plain (torch.equal); P1 {p1_ms:.4f} ms vs "
        f"plain {p1_plain_ms:.4f} ms a chunk (bound "
        f"{sweep['fused_range_scores']['sweep_bound_ms']:.4f} ms), S2 {s2_ms:.4f} "
        f"ms vs plain {s2_plain_ms:.4f} ms (bound "
        f"{sweep['dense_topk']['sweep_bound_ms']:.4f} ms), torch.topk "
        f"{sweep['dense_topk']['sweep_library_ms']:.4f} ms [{label}]"
    )
    print(
        f"(n) P1 written at the accumulator's row stride {strided['shape']['row_stride']}: "
        f"kernel {strided['ms']:.4f} ms on the card ({strided['launch_paced_ms']:.4f} back "
        f"to back), plain {strided['plain_ms']:.4f} ms, bound "
        f"{strided['bound_ms']:.4f} ms ({strided['bound_bytes']} B), {strided['active_lanes']} "
        f"active lanes, {strided['inactive_queries']:.4f} of queries inactive [{label}]"
    )
    del acc, post, starts, lens
    del p1_calls, s2_calls, restores
    torch.cuda.synchronize()
    score_kernel.LAUNCHES = topk.LAUNCHES = 0
    qps = []
    for _ in range(3):
        t0 = time.perf_counter()
        swept = f32_engine.search_rangescan_async(queries, K)()
        qps.append(len(queries) / (time.perf_counter() - t0))
    launches = {"fused_range_scores": score_kernel.LAUNCHES, "dense_topk": topk.LAUNCHES}
    for name, n_launched in launches.items():
        sweep[name]["sweep_launches"] = n_launched
    if not all(launches.values()):
        raise AssertionError(f"rangescan: a kernel never launched: {launches}")
    pruned = f32_engine.search(queries, K)
    if not all(np.array_equal(a, b) for a, b in zip(swept, pruned)):
        raise AssertionError("rangescan != the pruned engine")
    got = f32_engine.search_rangescan_async(sample, K)()
    want = f32_cpu.search_rangescan_async(sample, K)()
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("rangescan: GPU != CPU-plain")
    print(
        f"(n) rangescan: 3 x search_rangescan_async({len(queries)} queries, "
        f"k={K}); launches {launches}; QPS per batch {[round(x, 1) for x in qps]}; "
        f"ids and scores == the pruned engine on all {len(queries)} queries "
        f"({int((swept[1] >= 0).sum())} hits); GPU == CPU-plain on {AUDIT} "
        f"(1% deleted, as phase (e) left the engine) [{label}]"
    )
    return entries, sweep, b1_by_phase


def _live_lanes(win_lo, win_hi):
    return int((win_hi - win_lo).clamp_min(0).sum())


def e1_bound(a):
    """E1 on one dispatch ``a`` (the wrapper's arguments): each live lane's
    doc id and impact, its doc_live entry, each window's row, lanes and
    ordinal, and the [q, N+1] f32 accumulator written once; a multiply and
    an add a lane."""
    post_impact, win_row, n_docs = a[1], a[3], a[8]
    lanes = _live_lanes(a[4], a[5])
    return bound(
        lanes * (4 + post_impact.element_size()) + 4 * min(lanes, n_docs + 1)
        + 16 * win_row.numel() + 4 * win_row.shape[0] * (n_docs + 1),
        2 * lanes,
    )


def e1_fields(a, what, label):
    """E1 on one dispatch's arguments ``a`` (the rows must keep the
    planning's layout, so the parallel walk is timed): device ms and back
    to back, by doc tile; and with a filter (60% kept) fused into its write
    beside E1 unfiltered, the separate ``mul_`` pass alone on the same
    accumulator and E1 followed by that pass.  The fused result must equal
    the separate pass's (``torch.equal``)."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import exact_kernel

    if not exact_kernel.dense_rows_in_layout(a[0], *a[3:8]).all():
        raise AssertionError(f"{what}: a timed row is off the planning's layout")
    n_docs = a[8]

    def e1(fm=None):
        return exact_kernel.exact_dense_accumulate(*a, filter_mask=fm)

    gen = torch.Generator(device="cuda").manual_seed(13)
    fm = (torch.rand(n_docs + 1, device="cuda", generator=gen) < 0.6).float()
    fm[n_docs] = 1.0
    acc = e1()
    if not torch.equal(e1(fm), acc.clone().mul_(fm)):
        raise AssertionError(f"{what}: the fused filter != E1 then mul_")
    out = {
        "ms": device_ms(e1),
        "launch_paced_ms": cuda_ms(e1),
        "tile_ms": tile_sweep(e1),
        "filtered_ms": device_ms(lambda: e1(fm)),
        "mul_ms": device_ms(lambda: acc.mul_(fm)),
        "then_mul_ms": device_ms(lambda: e1().mul_(fm)),
    }
    print(
        f"{what}: rows on the layout; E1 {out['ms']:.4f} ms on the card "
        f"({out['launch_paced_ms']:.4f} back to back; one launch, every cell written, "
        f"no zero-fill); by doc tile: "
        + ", ".join(f"{t} {ms:.4f}" for t, ms in out["tile_ms"].items())
        + f"; with the filter fused {out['filtered_ms']:.4f} ms; the separate "
        f"acc.mul_(filter) alone {out['mul_ms']:.4f} ms, E1 then mul_ "
        f"{out['then_mul_ms']:.4f} ms [{label}]"
    )
    return out


def e3_bound(a):
    """E3 on one dispatch: each group's impacts and u8 locals, its id and
    ordinal, each real group's range and two starts, and the accumulator
    written once; an add a lane."""
    post_impact, tr_start, grp_ids, n_docs = a[0], a[3], a[4], a[7]
    g = grp_ids.long()
    lanes = int((tr_start[g + 1] - tr_start[g]).sum())
    n_grp = int((a[5] >= 0).sum())
    return bound(
        lanes * (1 + post_impact.element_size()) + 8 * grp_ids.numel()
        + 12 * n_grp + 4 * grp_ids.shape[0] * (n_docs + 1),
        lanes,
    )


def e3_fields(a):
    """E3 on one dispatch's arguments ``a``, on the card (queued behind a
    sleeping kernel) and back to back: the wrapper with its zero-fill, its
    one launch alone on an accumulator made beforehand (adding onto the
    sums of the calls before it: the same work), and the zero-fill alone;
    the launch's bound without the fill (each doc it touches read and
    written once in place of the whole accumulator written); and whether
    every row keeps the planning's layout, so the parallel path was timed."""
    from vectorchord_bm25_tpu_torch.ops import exact_kernel, topk

    imp, loc, trr, trs, gi, go, n_ord, n_docs, rs = a
    q = gi.shape[0]
    acc = topk.new_accumulator(q, n_docs, gi.device)
    touched = int((exact_kernel.exact_compact_accumulate(*a) != 0).sum())
    whole = e3_bound(a)
    alone = bound(
        whole["bound_bytes"] - 4 * q * (n_docs + 1) + 8 * touched, whole["bound_ops"]
    )

    def wrapper():
        return exact_kernel.exact_compact_accumulate(*a)

    def scatter():
        return exact_kernel.compact_scatter(acc, *a)

    return {
        "ms": device_ms(wrapper),
        "launch_paced_ms": cuda_ms(wrapper),
        "scatter_ms": device_ms(scatter),
        "scatter_launch_paced_ms": cuda_ms(scatter),
        "fill_ms": device_ms(lambda: topk.new_accumulator(q, n_docs, gi.device)),
        "scatter_bound_ms": alone["bound_ms"],
        "scatter_bound_bytes": alone["bound_bytes"],
        "touched_docs": touched,
        "rows_in_layout": bool(
            exact_kernel.compact_rows_in_layout(gi, go, trr, n_ord, n_docs, rs).all()
        ),
    }


def e2_bound(a):
    """E2 on one dispatch: each live lane's doc id and impact and its live
    and filter entries, each window's row and lanes, and one doc and one
    score written a lane; two multiplies a live lane."""
    post_impact, win_row, n_docs = a[1], a[4], a[7]
    lanes = _live_lanes(a[5], a[6])
    return bound(
        lanes * (4 + post_impact.element_size()) + 8 * min(lanes, n_docs + 1)
        + 12 * win_row.numel() + 8 * 128 * win_row.numel(),
        2 * lanes,
    )


def _held_to(got, want, what, same_ids):
    """Hold (scores, ids, payloads) to another engine's as the reference's
    tests/test_compact_exact.py does: the same hits a query, a rank may name
    another doc only where the two scores are within 1e-4, scores within
    rtol 1e-5; with ``same_ids`` every id must be equal.  Returns how many
    scores are not equal bit for bit."""
    (s, i, _), (s0, i0, _) = got, want
    if not np.array_equal(i >= 0, i0 >= 0):
        raise AssertionError(f"{what}: hit counts differ")
    live = i0 >= 0
    swapped = live & (i != i0)
    if same_ids and swapped.any():
        raise AssertionError(f"{what}: {int(swapped.sum())} ids differ")
    if swapped.any() and float(np.abs(s[swapped] - s0[swapped]).max()) >= 1e-4:
        raise AssertionError(f"{what}: ranks differ beyond score ties")
    np.testing.assert_allclose(s[live], s0[live], rtol=1e-5, err_msg=what)
    return int((s[live] != s0[live]).sum())


def exact_hybrid(args, seg, seed, queries, ri, bm_engine, label):
    """Phases (o)-(q): the exact engine (dense f32, bf16, compact, shared)
    and the hybrid engine's routes on the 131,072-doc corpus and its
    RangeIndex; ``bm_engine`` is phase (d)'s BlockMaxEngine, which holds
    phase (e)'s deletes.  Returns the kernels-line entries of E1, E1 on
    bf16 and E3, and P1's, S2's and B1's launches by phase."""
    import torch

    from vectorchord_bm25_tpu_torch import Bm25Index, IndexOptions
    from vectorchord_bm25_tpu_torch.ops import exact_kernel, score_kernel, topk
    from vectorchord_bm25_tpu_torch.search import exact
    from vectorchord_bm25_tpu_torch.search.exact import ExactEngine
    from vectorchord_bm25_tpu_torch.search.hybrid import HybridEngine
    from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup

    rng = np.random.default_rng(args.seed + 6)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    n, v, p = seg.n_docs, seg.n_tokens, ri.post_local.size
    n_post = int(seg.block_n.sum())
    rows = -(-max(n_post, 1) // 128) + 1  # with the pad row
    dense_name, compact_name = "exact_dense_accumulate", "exact_compact_accumulate"

    def build(engine_kind, opts, device="cuda"):
        return Bm25Index(
            seg, seed, IndexOptions(), engine=engine_kind, engine_options=opts,
            device=device,
        )

    def check(engine, name, bound_of, what):
        """Every dispatch ``engine.search`` hands the kernel ``name``
        against its plain version; both timed on the largest dispatch."""
        restore, calls = _record(exact, name)
        try:
            engine.search(queries, K)
        finally:
            restore()
        # The window (group) matrix is argument 3 (4); largest dispatch first.
        matrix = 3 if name == dense_name else 4
        calls.sort(key=lambda c: -c[0][matrix].numel())
        err, ms, plain_ms = _kernel_vs_plain(
            getattr(exact_kernel, name), getattr(exact_kernel, name + "_plain"),
            calls, what,
        )
        big = calls[0][0]
        kb = bound_of(big)
        shape = tuple(big[matrix].shape)
        print(
            f"{what}: {len(calls)} dispatches a batch, kernel == plain on every "
            f"one (torch.equal); largest {shape}, {kb['bound_bytes']} B to "
            f"move: kernel {ms:.4f} ms (back to back), plain {plain_ms:.4f} ms "
            f"(with its zero-fill), bound {kb['bound_ms']:.4f} ms "
            f"({kb['bound_by']}) [{label}]"
        )
        if name != compact_name:
            return {"max_abs_err": err, "plain_ms": plain_ms, **kb, **e1_fields(big, what, label)}
        f = e3_fields(big)
        if not f["rows_in_layout"]:
            raise AssertionError(f"{what}: a timed row is off the planning's layout")
        print(
            f"{what} on {shape} groups, every row on the planning's layout: with "
            f"its zero-fill {f['ms']:.4f} ms on the card ({f['launch_paced_ms']:.4f} "
            f"back to back), bound {kb['bound_ms']:.4f} ms; the launch alone "
            f"{f['scatter_ms']:.4f} ms on the card ({f['scatter_launch_paced_ms']:.4f} "
            f"back to back), bound {f['scatter_bound_ms']:.4f} ms "
            f"({f['scatter_bound_bytes']} B, {f['touched_docs']} docs touched); the "
            f"zero-fill alone {f['fill_ms']:.4f} ms [{label}]"
        )
        return {"max_abs_err": err, "plain_ms": plain_ms, **kb, **f}

    def entry(name, source, line, launches, by_phase, measured):
        return {
            "name": name,
            "route": "cuda",
            "source": f"vectorchord_bm25_tpu_torch/csrc/{source}",
            "replaces": f"vectorchord_bm25_tpu/search/exact.py:{line}",
            "launches": launches,
            "launches_by_phase": by_phase,
            **measured,
            "library_ms": None,
        }

    def served(phase, what, qps, launches):
        print(
            f"{phase} {what}: {len(qps)} x search_batch({len(queries)} queries, "
            f"k={K}); launches {launches}; QPS per batch "
            f"{[round(x, 1) for x in qps]} (median {float(np.median(qps)):.1f}) [{label}]"
        )

    p1_by_phase, s2_by_phase, b1_by_phase = {}, {}, {}

    # (o) exact, dense f32 rows
    index = build("exact", {})
    engine = index.engine()
    if type(engine) is not ExactEngine or engine.compact or not engine.dev.post_docid.is_cuda:
        raise AssertionError(f"engine='exact' built {engine!r}")
    e1 = check(engine, dense_name, e1_bound, "(o) E1 f32")
    s2 = (topk, "LAUNCHES", "S2")
    p1 = (score_kernel, "LAUNCHES", "P1")
    counters = [(exact_kernel, "DENSE_LAUNCHES"), s2]
    qps, launches, _ = _serve(index, queries, counters, "exact")
    served("(o)", f"exact ({launches['S2'] // ROUNDS} dispatches a batch)", qps, launches)
    e1_launches = launches["DENSE_LAUNCHES"]
    s2_by_phase["(o)"] = launches["S2"]
    want_bytes = rows * 128 * 8 + 4 * (n + 1)
    got_bytes = engine.memory_report()["total"]
    if got_bytes != want_bytes:
        raise AssertionError(f"exact memory_report total {got_bytes} != {want_bytes}")
    cpu = build("exact", {}, "cpu")
    recall, total, ties, n_del = audit(index, cpu, seg, sample)
    del cpu
    print(
        f"(o) {AUDIT} sampled queries: GPU == CPU-plain, also after deleting "
        f"{n_del} docs (1%) and with a prefilter; recall@{K} vs the float64 "
        f"oracle {recall} ({total} hits, {ties} boundary ties excused); "
        f"memory_report total {got_bytes} B == the reference's formula"
    )
    # The yardstick of (p) and (q): the dense f32 engine with the 1% deleted,
    # as every engine below is (bulkdelete, or phase (e)'s deletes).
    engine = index.engine()
    f32 = engine.search(queries, K)

    # (p) bf16 rows
    index_bf = build("exact", {"impact_dtype": "bfloat16"})
    bf = index_bf.engine()
    if bf.dev.post_impact.dtype != torch.bfloat16:
        raise AssertionError("impact_dtype='bfloat16' did not give bf16 rows")
    e1_bf = check(bf, dense_name, e1_bound, "(p) E1 bf16")
    counters = [(exact_kernel, "DENSE_BF16_LAUNCHES"), s2]
    qps, launches, _ = _serve(index_bf, queries, counters, "exact bf16")
    served("(p)", "exact, bf16 rows", qps, launches)
    bf_launches = launches["DENSE_BF16_LAUNCHES"]
    s2_by_phase["(p) bf16"] = launches["S2"]
    want_bytes = rows * 128 * 6 + 4 * (n + 1)
    if bf.memory_report()["total"] != want_bytes:
        raise AssertionError(f"bf16 memory_report total != {want_bytes}")
    index_bf.bulkdelete(doomed)
    s_bf, i_bf, _ = index_bf.engine().search(queries, K)
    s_32, i_32, _ = f32
    if not np.array_equal(i_bf >= 0, i_32 >= 0):
        raise AssertionError("bf16 and f32 return different hit counts")
    live = i_32 >= 0
    np.testing.assert_allclose(s_bf[live], s_32[live], rtol=6e-3)
    hit = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(i_bf, i_32))
    print(
        f"(p) bf16: scores per rank within rtol 6e-3 of the f32 engine's on "
        f"{len(queries)} queries (1% deleted on both), recall@{K} vs the f32 "
        f"engine {hit / max(1, int(live.sum())):.6f}; memory_report total "
        f"{want_bytes} B == the reference's formula"
    )
    del index_bf, bf

    # (p) compact, and shared with phase (d)'s Block-Max engine
    index_c = build("exact", {"compact": True})
    compact = index_c.engine()
    if not compact.compact:
        raise AssertionError("compact=True did not give the compact engine")
    e3 = check(compact, compact_name, e3_bound, "(p) E3 compact")
    counters = [(exact_kernel, "COMPACT_LAUNCHES"), s2]
    qps, launches, _ = _serve(index_c, queries, counters, "exact compact")
    served("(p)", "exact, compact", qps, launches)
    e3_by_phase = {"(p) compact": launches["COMPACT_LAUNCHES"]}
    s2_by_phase["(p) compact"] = launches["S2"]
    cri = compact._ranges
    want_bytes = 5 * cri.post_local.size + 8 * (cri.tr_range.size + 1) + 4 + 4 * (n + 1)
    if compact.memory_report()["total"] != want_bytes:
        raise AssertionError(f"compact memory_report total != {want_bytes}")
    index_c.bulkdelete(doomed)
    unequal = _held_to(index_c.engine().search(queries, K), f32, "compact vs dense", False)
    print(
        f"(p) compact: hits, ranks and scores held to the dense f32 engine's on "
        f"{len(queries)} queries ({unequal} scores not bit-equal); "
        f"memory_report total {want_bytes} B == the reference's formula"
    )
    del index_c, compact
    shared = ExactEngine(seg, share=bm_engine)
    names = ("dev_post_impact", "dev_post_local", "dev_tr_range", "dev_tr_start")
    if shared.dev is not bm_engine.dev or any(
        getattr(shared, x).data_ptr() != getattr(bm_engine, x).data_ptr() for x in names
    ):
        raise AssertionError("share= did not alias the Block-Max engine's tensors")
    e3_shared = check(shared, compact_name, e3_bound, "(p) E3 shared")
    exact_kernel.COMPACT_LAUNCHES = topk.LAUNCHES = 0
    got = shared.search(queries, K)
    e3_by_phase["(p) shared"] = exact_kernel.COMPACT_LAUNCHES
    s2_by_phase["(p) shared"] = topk.LAUNCHES
    if not e3_by_phase["(p) shared"]:
        raise AssertionError("the shared engine never launched E3")
    unequal = _held_to(got, f32, "shared vs dense", False)
    print(
        f"(p) share=: tensors alias the Block-Max engine's (data_ptr); E3 "
        f"{e3_shared['ms']:.4f} ms vs plain {e3_shared['plain_ms']:.4f} ms; "
        f"{e3_by_phase['(p) shared']} launches a batch; held to the dense f32 "
        f"engine's on {len(queries)} queries ({unequal} scores not bit-equal)"
    )
    del shared, got

    # (q) hybrid: the routes into the exact engine, P1 and the range sweep
    def hybrid(opts):
        index_h = build("hybrid", {"range_index": ri, **opts})
        if type(index_h.engine()) is not HybridEngine:
            raise AssertionError("engine='hybrid' did not build the HybridEngine")
        index_h.bulkdelete(doomed)
        return index_h, index_h.engine()

    def held_e1(engine, phase):
        """One batch with every E1 call held to its plain version; returns
        the calls checked."""
        restore, st = _checked(
            exact, dense_name, exact_kernel.exact_dense_accumulate_plain,
            lambda a: a[3].numel(), _finite_err,
        )
        try:
            engine.search(queries, K)
        finally:
            restore()
        e1_held[phase] = st["checked"]
        return st["checked"]

    e1_held = {}
    counters = [(exact_kernel, "DENSE_LAUNCHES"), s2]
    index_h, hyb = hybrid({})
    looked_up = (*batch_lookup(seg.lookup_tokens, queries), len(queries))
    routes = np.bincount(hyb._route(*looked_up)[0], minlength=3)
    if not held_e1(hyb, "(q1)"):
        raise AssertionError("(q1): the hybrid engine made no E1 call")
    qps, launches, _ = _serve(index_h, queries, counters, "hybrid", rounds=3)
    if hyb._blockmax is not None:
        raise AssertionError("the default hybrid built the Block-Max engine")
    if not all(np.array_equal(a, b) for a, b in zip(hyb.search(queries, K), f32)):
        raise AssertionError("default hybrid != the exact engine")
    served(
        "(q1)", f"hybrid, default heavy_mode (one-shot/dense/heavy {routes.tolist()}; "
        f"Block-Max never built; results == phase (o)'s; {e1_held['(q1)']} E1 calls "
        f"== plain, torch.equal)", qps, launches,
    )
    hybrid_e1 = launches["DENSE_LAUNCHES"]
    s2_by_phase["(q1)"] = launches["S2"]
    del index_h, hyb

    threshold = 0.10
    while True:
        probe = HybridEngine(seg, ri, route_threshold=threshold, oneshot_cap=64)
        routes = np.bincount(probe._route(*looked_up)[0], minlength=3)
        if routes[2] or threshold < 1e-4:
            break
        threshold /= 2
    if not routes[2]:
        raise AssertionError("no query takes the heavy route at any threshold")
    print(
        f"(q) route_threshold {threshold} (default 0.10, halved until a query "
        f"takes the heavy route), oneshot_cap 64: one-shot/dense/heavy "
        f"{routes.tolist()} of {len(queries)} queries"
    )
    for phase, opts, e_counter in (
        (
            "(q2)",
            {"heavy_mode": "pruned", "memory_mode": "compact", "oneshot_cap": 64},
            "COMPACT_LAUNCHES",
        ),
        ("(q3)", {"heavy_mode": "rangescan", "oneshot_cap": 64}, "DENSE_LAUNCHES"),
    ):
        index_h, hyb = hybrid({**opts, "route_threshold": threshold})
        # _serve raises unless every counter it is given grew: P1 always
        # (the one-shot and heavy groups), the exact engine's kernel and S2
        # where some query takes the dense route (S2 also ends the sweep).
        counters = [p1, (exact_kernel, e_counter), s2]
        if not routes[1]:
            counters = [p1] if phase == "(q2)" else [p1, s2]
        # B1 runs wherever P1 does: the one-shot and pruned groups' rounds.
        counters += b1_counters()
        if phase == "(q3)" and routes[1] and not held_e1(hyb, phase):
            raise AssertionError("(q3): the dense route made no E1 call")
        qps, launches, _ = _serve(index_h, queries, counters, phase, rounds=3)
        p1_by_phase[phase] = launches["P1"]
        b1_by_phase[phase] = {name: launches[name] for name in B1_NAMES}
        s2_by_phase[phase] = launches.get("S2", 0)
        with select_held(phase) as held:
            unequal = _held_to(hyb.search(queries, K), f32, f"hybrid {phase} vs exact", True)
        if not held:
            raise AssertionError(f"{phase}: no B1-select call to hold")
        rep = hyb.memory_report()
        if phase == "(q2)":
            e3_by_phase[phase] = launches.get(e_counter, 0)
            want_bytes = 5 * p + 12 * (ri.tr_range.size + 1) + 4 + 4 * (v + 2) + 4 * (n + 1)
            if rep["total"] != want_bytes or "dense_strategy_bytes" in rep:
                raise AssertionError(f"compact hybrid memory_report {rep} != one copy {want_bytes}")
            if hyb.exact.dev_post_impact.data_ptr() != hyb.blockmax.dev_post_impact.data_ptr():
                raise AssertionError("compact hybrid holds two copies of the postings")
        else:
            hybrid_e1 += launches.get(e_counter, 0)
        served(
            phase, f"hybrid {opts} (P1 {p1_by_phase[phase]} launches, B1 "
            f"{b1_by_phase[phase]}, S2 {s2_by_phase[phase]}; {len(held)} B1-select calls "
            f"of a batch == round_select_plain; ids == phase (o)'s on all {len(queries)} "
            f"queries, {unequal} scores not bit-equal; memory_report total "
            f"{rep['total']} B)", qps, launches,
        )
        del index_h, hyb
    entries = [
        entry(
            dense_name, "exact_dense.cu", 148, e1_launches + hybrid_e1,
            {"(o)": e1_launches, "(q)": hybrid_e1}, {**e1, "held_calls": e1_held},
        ),
        entry(
            dense_name + "_bf16", "exact_dense.cu", 148, bf_launches,
            {"(p)": bf_launches}, e1_bf,
        ),
        entry(
            compact_name, "exact_compact.cu", 95, sum(e3_by_phase.values()),
            e3_by_phase, {**e3, "shared_ms": e3_shared["ms"]},
        ),
    ]
    return entries, p1_by_phase, s2_by_phase, b1_by_phase


def _checked(module, name, plain, size, errs):
    """Replace ``module.name`` by a wrapper that launches the kernel as the
    engine asked, then runs its plain version on the same inputs and raises
    unless the two are ``torch.equal``.  ``errs(out, want)`` gives the max
    abs error of the float outputs.  Returns (restore, stats): stats counts
    the dispatches checked, keeps the largest error and the inputs of the
    largest dispatch (``size(args)`` lanes) for timing."""
    import torch

    real = getattr(module, name)
    stats = {"name": name, "real": real, "plain": plain, "checked": 0,
             "err": 0.0, "args": None, "kw": {}, "size": -1}

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name} != its plain version on a dispatch")
        stats["err"] = max(stats["err"], errs(out, want))
        stats["checked"] += 1
        if size(args) > stats["size"]:
            stats["args"], stats["kw"], stats["size"] = args, kw, size(args)
        return out

    setattr(module, name, wrapper)
    return (lambda: setattr(module, name, real)), stats


def _finite_err(a, b):
    import torch

    live = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(live, a - b, 0.0).abs().max()) if a.numel() else 0.0


def rescore_plain_held(phase, held):
    """``rescore_topk_plain`` for ``_checked``, which first holds S5's
    scores-only entry (``stream_rescore``, the same kernel writing its
    ``[Q, C]`` scores) to ``stream_rescore_plain`` on the same inputs
    (``torch.equal``) and appends to ``held`` for each call it checked."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import stream_rescore as sr

    def plain(*a):
        got = sr.stream_rescore(*a[:9], a[10])
        want = sr.stream_rescore_plain(*a[:9], a[10])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{phase} stream_rescore != its plain version")
        held.append(None)
        return sr.rescore_topk_plain(*a)

    return plain


def s5_fields(a):
    """S5 timed on one ``rescore_topk`` call's inputs (words, s1_eff, the
    four window tables, cand, t_lo, t_hi, k, n_docs): the main path's call
    on the card (launches queued behind a sleeping kernel) and back to back;
    the scores-only launch; the two-step composition scores, then
    ``lex_topk``, its ``where`` and pads (``topk_of_scores``); the plain
    version; and ``torch.topk`` on the packed keys of the same scores (the
    selection half alone)."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import stream_rescore as sr
    from vectorchord_bm25_tpu_torch.ops import topk

    cand, k, n_docs = a[6], a[9], a[10]
    kk = min(k, cand.shape[1])

    def fused():
        sr.rescore_topk(*a)

    def scores_only():
        return sr.stream_rescore(*a[:9], n_docs)

    def pair():
        sr.topk_of_scores(scores_only(), cand, k)

    keys = topk._pack(scores_only(), cand)

    def library():
        torch.topk(keys, kk, dim=1, largest=False, sorted=True)

    return {
        "ms": device_ms(fused),
        "launch_paced_ms": cuda_ms(fused),
        "scores_ms": device_ms(scores_only),
        "scores_launch_paced_ms": cuda_ms(scores_only),
        "pair_ms": device_ms(pair),
        "pair_launch_paced_ms": cuda_ms(pair),
        "plain_ms": cuda_ms(lambda: sr.rescore_topk_plain(*a), iters=2, warmup=1),
        "library_ms": device_ms(library),
        "library_launch_paced_ms": cuda_ms(library),
        "shape": {"Q": cand.shape[0], "C": cand.shape[1], "T": a[7].shape[1], "k": k},
    }


def calls_device_ms(fn, module, names):
    """Records the inputs of every call ``fn()`` makes to each
    ``module.name`` of ``names``, then times each call again on those
    inputs on the card (``device_ms``); returns {name: (device ms summed
    over the calls, calls)}: the card time the batch spends in them."""
    real = {name: getattr(module, name) for name in names}
    seen = {name: [] for name in names}

    def recorder(name):
        def wrapper(*a, **kw):
            seen[name].append((a, kw))
            return real[name](*a, **kw)
        return wrapper

    for name in names:
        setattr(module, name, recorder(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(module, name, real[name])
    return {
        name: (
            sum(device_ms(lambda: real[name](*a, **kw), iters=3, warmup=1) for a, kw in calls),
            len(calls),
        )
        for name, calls in seen.items()
    }


def _deepest(module, name, pred, size):
    """Wrap ``module.name`` (after ``_checked``) to keep the inputs of its
    largest call, by ``size(args)``, for which ``pred(args, kw)`` holds."""
    real = getattr(module, name)
    kept = {"args": None, "kw": {}, "size": -1}

    def wrapper(*a, **kw):
        if pred(a, kw) and size(a) > kept["size"]:
            kept.update(args=a, kw=kw, size=size(a))
        return real(*a, **kw)

    setattr(module, name, wrapper)
    return (lambda: setattr(module, name, real)), kept


def sparse_merge_timings(call, plain, chain, a, kw):
    """SP-stream or SP-exact (``call``) on one dispatch's inputs: on the card
    (launches queued behind a sleeping kernel) and back to back, its plain
    version, and the parent's chain (``chain()``: S3 or E2, the stable
    ``torch.sort`` and gather, S4, ``select_keys``), whose output must equal
    the kernel's (``torch.equal``)."""
    import torch

    def f():
        return call(*a, **kw)

    got, want = f(), chain()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("the parent's chain != the sparse merge kernel")
    del got, want
    peaks = []
    for g in (f, chain):  # device memory one call takes beyond what is held
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - held)
    return {
        "peak_extra_bytes": peaks[0],
        "parent_chain_peak_extra_bytes": peaks[1],
        "ms": device_ms(f, iters=5, warmup=1),
        "launch_paced_ms": cuda_ms(f, iters=5, warmup=1),
        "plain_ms": cuda_ms(lambda: plain(*a, **kw), iters=2, warmup=1),
        "parent_chain_ms": device_ms(chain, iters=3, warmup=1),
        "parent_chain_launch_paced_ms": cuda_ms(chain, iters=3, warmup=1),
    }


def held_pair(kernel, plain, a, what):
    """``kernel(*a)`` against ``plain(*a)`` (``torch.equal``), both timed:
    (output, max abs err of the scores, kernel ms on the card, plain ms)."""
    import torch

    out, want = kernel(*a), plain(*a)
    torch.cuda.synchronize()
    pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"{what} != its plain version")
    err = _finite_err(out[1], want[1]) if isinstance(out, tuple) else 0.0
    return (
        out, err, device_ms(lambda: kernel(*a), iters=5, warmup=1),
        cuda_ms(lambda: plain(*a), iters=2, warmup=1),
    )


def s4_fields(s4_a, phase):
    """S4 held and timed on the parent chain's sorted lanes of a dispatch:
    doc and score read, one packed key written a lane."""
    from vectorchord_bm25_tpu_torch.ops import stream_sparse

    _, _, ms, plain_ms = held_pair(
        stream_sparse.sparse_combine, stream_sparse.sparse_combine_plain, s4_a, f"{phase} S4"
    )
    lanes = s4_a[0].numel()
    return {
        "ms": ms, "plain_ms": plain_ms, **bound(16 * lanes, lanes), "library_ms": None,
        "max_abs_err": 0.0,
    }


def exact_sparse(args, seg, batches, label, build_times):
    """Phase (r): the exact engine where its ``auto`` strategy is the sparse
    path, on phase (i)'s corpus and query mixes: SP-exact
    (``exact_sparse_topk``, one launch a dispatch) held to its plain version
    on every call, timed on the largest beside the parent's chain (E2, the
    sort, S4, ``select_keys``), E2 and S4 held there too.  Returns the
    kernels-line entries of SP-exact and E2 and S4's fields on E2's lanes."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import exact_kernel, stream_sparse
    from vectorchord_bm25_tpu_torch.search import exact as exact_mod
    from vectorchord_bm25_tpu_torch.search.exact import ExactEngine

    t0 = time.perf_counter()
    engine = ExactEngine(seg, device="cuda")
    build_times["(r) exact engine's posting rows"] = time.perf_counter() - t0
    if engine.strategy != "auto" or seg.n_docs < engine.SPARSE_MIN_DOCS or engine.compact:
        raise AssertionError(f"{seg.n_docs} docs are not served by the sparse strategy")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    restore, c = _checked(
        exact_mod, "exact_sparse_topk", exact_kernel.exact_sparse_topk_plain,
        lambda a: a[4].numel() * 128, lambda out, want: _finite_err(out[0], want[0]),
    )
    try:
        for queries in batches.values():
            engine.search(queries, K)
    finally:
        restore()
    if not c["checked"]:
        raise AssertionError("SP-exact saw no dispatch")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    a, kw = c["args"], c["kw"]
    n = kw["n_docs"]
    e2_a = (*a[:7], n)

    def chain():
        doc, sc = exact_kernel.exact_sparse_gather(*e2_a)
        return stream_sparse.sparse_lanes_topk(doc, sc, kw["k"], n, kw["seg_steps"])

    m = sparse_merge_timings(exact_kernel.exact_sparse_topk, exact_kernel.exact_sparse_topk_plain,
                      chain, a, kw)
    (doc, sc), e2_err, e2_ms, e2_plain = held_pair(
        exact_kernel.exact_sparse_gather, exact_kernel.exact_sparse_gather_plain, e2_a, "(r) E2"
    )
    df, perm = torch.sort(doc, dim=1, stable=True)
    s4 = s4_fields((df, sc.gather(1, perm), n, kw["seg_steps"]), "(r)")
    del doc, sc, df, perm
    e2b = e2_bound(e2_a)
    lanes = _live_lanes(a[5], a[6])
    kb = bound(
        lanes * (4 + a[1].element_size()) + 8 * min(lanes, n + 1) + 12 * a[4].numel()
        + 4 * kw["seg_off"].numel() + 8 * a[4].shape[0] * kw["k"],
        3 * lanes,
    )
    print(
        f"(r) SP-exact exact_sparse_topk: {c['checked']} dispatches equal to the plain "
        f"version (torch.equal, pad ids included); largest {tuple(a[4].shape)} windows "
        f"({c['size']} lanes, k={kw['k']}, {kw['seg_off'].shape[1] - 1} segments) "
        f"{m['ms']:.4f} ms on the card ({m['launch_paced_ms']:.4f} back to back), bound "
        f"{kb['bound_ms']:.4f} ms ({kb['bound_bytes']} B); the parent's chain E2 -> sort "
        f"-> S4 -> select_keys {m['parent_chain_ms']:.4f} ms on the card "
        f"({m['parent_chain_launch_paced_ms']:.4f} back to back), E2 alone {e2_ms:.4f} ms "
        f"(bound {e2b['bound_ms']:.4f}), S4 alone {s4['ms']:.4f} ms; plain "
        f"{m['plain_ms']:.4f} ms [{label}]"
    )
    c["args"] = a = None

    # The main path: every count from 0, 3 batches of each mix.
    exact_kernel.MERGE_LAUNCHES = exact_kernel.SPARSE_LAUNCHES = 0
    stream_sparse.COMBINE_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mix, queries in batches.items():
        qps = []
        for _ in range(3):
            t0 = time.perf_counter()
            scores, ids, _ = engine.search(queries, K)
            qps.append(len(queries) / (time.perf_counter() - t0))
        live = ids >= 0
        if not live.any() or not (np.isfinite(scores[live]).all() and (scores[live] > 0).all()):
            raise AssertionError(f"(r) {mix} results are not finite positive hits")
        print(
            f"(r) {mix}: 3 x ExactEngine.search({len(queries)} queries, k={K}) at "
            f"{seg.n_docs} docs, sparse strategy; QPS per batch "
            f"{[round(x, 1) for x in qps]} [{label}]"
        )
    torch.cuda.synchronize()
    path_peak = torch.cuda.max_memory_allocated()
    launches = exact_kernel.MERGE_LAUNCHES
    old = (exact_kernel.SPARSE_LAUNCHES, stream_sparse.COMBINE_LAUNCHES)
    if not launches or any(old):
        raise AssertionError(f"(r) launched SP-exact {launches} times, E2 and S4 {old}")

    # The card against the CPU-plain engine, and against the oracle.
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 7)

    def pick(n):
        return [
            queries[i]
            for queries in batches.values()
            for i in np.sort(rng.choice(len(queries), min(n, len(queries)), replace=False))
        ]

    sample = pick(SPARSE_AUDIT // 2)
    cpu = ExactEngine(seg, device="cpu")
    got, want = engine.search(sample, K), cpu.search(sample, K)
    del cpu
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("(r) GPU != CPU-plain")
    sample = pick(AUDIT // 2)
    scores, ids, pays = engine.search(sample, K)
    hits = [
        [(float(sc), int(p)) for sc, i, p in zip(*row) if i >= 0]
        for row in zip(scores, ids, pays)
    ]
    recall, total, ties = recall_vs_oracle(seg, sample, hits, K)
    if recall != 1.0:
        raise AssertionError(f"(r) recall@{K} vs oracle {recall} != 1.0")
    torch.cuda.synchronize()
    print(
        f"(r) SP-exact {launches} launches, E2 and S4 none; GPU == CPU-plain on "
        f"{SPARSE_AUDIT} queries; recall@{K} vs the float64 oracle {recall} on "
        f"{len(sample)} queries ({total} hits, {ties} boundary ties excused); peak "
        f"device memory of the 6 timed batches {path_peak} B (with every call held to "
        f"its plain version {peak} B; index {engine.memory_report()['total']} B); on the "
        f"largest dispatch one SP-exact call takes {m['peak_extra_bytes']} B beyond what "
        f"is held, the parent's chain {m['parent_chain_peak_extra_bytes']} B; audits "
        f"took {time.perf_counter() - t0:.1f} s [{label}]"
    )
    sp_entry = {
        "name": "exact_sparse_topk",
        "route": "cuda",
        "source": "vectorchord_bm25_tpu_torch/csrc/exact_merge.cu",
        "replaces": "vectorchord_bm25_tpu/search/exact.py:185",
        "launches": launches,
        "launches_by_phase": {"(r)": launches},
        "max_abs_err": c["err"],
        **m,
        **kb,
        "library_ms": None,
        "path_peak_bytes": path_peak,
    }
    e2_entry = {
        "name": "exact_sparse_gather",
        "route": "cuda",
        "source": "vectorchord_bm25_tpu_torch/csrc/exact_sparse.cu",
        "replaces": "vectorchord_bm25_tpu/search/exact.py:217",
        "launches": 0,
        "launches_by_phase": {"(r)": 0},
        "max_abs_err": e2_err,
        "ms": e2_ms,
        "plain_ms": e2_plain,
        **e2b,
        "library_ms": None,
    }
    return [sp_entry, e2_entry], s4


# The fields of S5's kernels-line entry besides the common ones.
S5_EXTRA = (
    "launch_paced_ms", "scores_ms", "scores_launch_paced_ms", "pair_ms",
    "pair_launch_paced_ms", "library_launch_paced_ms", "scores_bound", "shape",
)


def sparse_slice(args, label, build_times):
    """Phases (i)-(j) and (r): the served default at scale, where ``auto``
    leaves the dense path, then the exact engine on the same corpus.  Returns
    the kernels-line entries of S3, S4, S5 and E2."""
    import torch

    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        IndexOptions,
        build_sealed_segment_from_postings,
    )
    from vectorchord_bm25_tpu_torch.data.synth import (
        synth_corpus_postings,
        synth_queries_fast,
        synth_queries_from_segment,
    )
    from vectorchord_bm25_tpu_torch.ops import stream_rescore, stream_sparse, topk
    from vectorchord_bm25_tpu_torch.search import stream as stream_mod
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    # (i) the corpus: bench.py's generator and shape, only the doc count raised
    t0 = time.perf_counter()
    n = args.sparse_docs
    keys, doc_ids, tfs, doc_start = synth_corpus_postings(
        n, args.vocab, args.avg_len, seed=args.seed
    )
    seg = build_sealed_segment_from_postings(keys, doc_ids, tfs, n, doc_grouped=True)
    batches = {
        "informative": synth_queries_fast(
            keys, doc_start, seg, SPARSE_BATCH, seed=args.seed + 1
        ),
        "heavy": synth_queries_from_segment(
            seg, SPARSE_BATCH, args.vocab, seed=args.seed + 2, mix="heavy"
        ),
    }
    build_times["(i) corpus, segment and queries"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = Bm25Index(seg, args.seed.to_bytes(16, "little"), IndexOptions(), device="cuda")
    engine = index.engine()
    build_times["(i) stream index"] = time.perf_counter() - t0
    si = engine.stream
    if (
        index.engine_kind != "stream"
        or type(engine) is not StreamEngine
        or engine.strategy != "auto"
        or seg.n_docs < engine.SPARSE_MIN_DOCS
    ):
        raise AssertionError(
            f"{seg.n_docs} docs served by {index.engine_kind} / {engine!r}, "
            f"not the stream engine's auto strategy at scale"
        )
    print(
        f"(i) {seg.n_docs} docs (>= SPARSE_MIN_DOCS {engine.SPARSE_MIN_DOCS}), "
        f"{si.n_postings} postings in {si.n_windows} windows; host build "
        f"{build_times['(i) corpus, segment and queries']:.1f} s (corpus, "
        f"segment, queries) + {build_times['(i) stream index']:.1f} s (stream "
        f"index); device index {engine.memory_report()['total']} B"
    )

    # Every dispatch the engine hands SP-stream and S5 against the plain
    # versions (S5: its scores and ids, and its scores-only entry on the
    # same inputs); the deepest pool's dispatch kept for timing too.
    scores_held = []
    checks = [
        _checked(
            stream_mod, "stream_sparse_topk", stream_sparse.stream_sparse_topk_plain,
            lambda a: a[6].numel() * 128, lambda out, want: _finite_err(out[0], want[0]),
        ),
        _checked(
            stream_mod, "rescore_topk", rescore_plain_held("(i)", scores_held),
            lambda a: a[6].numel() * a[7].shape[1],
            lambda out, want: _finite_err(out[0], want[0]),
        ),
    ]
    undeep, deep = _deepest(
        stream_mod, "stream_sparse_topk", lambda a, kw: a[7] >= 512, lambda a: a[6].numel()
    )
    try:
        for mix, queries in batches.items():
            index.search_batch(queries, K)
            st = engine.last_ms_stats
            print(
                f"(i) {mix}: {len(queries)} queries, routed to MaxScore "
                f"{st and st['routed_queries']}; dispatches checked so far: "
                + ", ".join(f"{c['name']} {c['checked']}" for _, c in checks)
                + f", stream_rescore (scores only) {len(scores_held)} (torch.equal)"
            )
    finally:
        undeep()
        for restore, _ in checks:
            restore()
    stats = [c for _, c in checks]
    if not all(c["checked"] for c in stats) or deep["args"] is None:
        raise AssertionError(f"a kernel saw no dispatch: {[c['checked'] for c in stats]}")
    n = seg.n_docs

    def decode_bound(a):
        # Each window's words and meta, one doc and one score written a lane.
        wsrc = a[6].cpu().numpy().ravel()
        n_words, lanes, n_win = window_words(si, wsrc)
        return bound(
            4 * n_words + 14 * n_win + 4 * wsrc.size + 4 * min(lanes, n + 1)
            + 8 * 128 * wsrc.size,
            3 * lanes,
        )

    def merge_bound(a):
        # SP-stream: each window's words and meta and each live lane's
        # s1_eff read once, the segments read, [Q, k] scores and ids written.
        wsrc = a[6].cpu().numpy().ravel()
        n_words, lanes, n_win = window_words(si, wsrc)
        return bound(
            4 * n_words + 14 * n_win + 4 * wsrc.size + 4 * min(lanes, n + 1)
            + 4 * a[10].numel() + 8 * a[6].shape[0] * a[7],
            3 * lanes,
        )

    def rescore_bound(a):
        # rescore_topk: the candidates, their s1_eff entries, the spans and
        # each window some candidate falls in (its words and meta) read once,
        # the [Q, k] scores and ids written; the scores-only entry writes
        # [Q, C] scores instead.
        cand, t_lo, t_hi = (x.cpu().numpy() for x in a[6:9])
        k = a[9]
        wins = set()
        for qi in range(cand.shape[0]):
            cq = cand[qi][cand[qi] < n]
            for lo, hi in zip(t_lo[qi], t_hi[qi]):
                if hi > lo and cq.size:
                    w = lo + np.searchsorted(si.w_base[lo:hi], cq, side="right") - 1
                    wins.update(np.unique(w[w >= lo]).tolist())
        n_words, lanes, n_win = window_words(si, np.fromiter(wins, np.int64))
        read = (
            4 * n_words + 14 * n_win + 4 * cand.size + 4 * int((cand < n).sum())
            + 8 * t_lo.size
        )
        ops = 4 * cand.size * t_lo.shape[1]
        return {
            **bound(read + 8 * cand.shape[0] * k, ops),
            "scores_bound": bound(read + 4 * cand.size, ops),
        }

    # SP-stream on its largest dispatch and its deepest pool's, beside the
    # parent's chain on the same inputs; S3 and S4 held and timed there.
    sp, s5 = stats
    a = sp["args"]

    def chain_of(a):
        def chain():
            doc, sc = stream_sparse.stream_sparse_decode(*a[:7], a[8])
            return stream_sparse.sparse_lanes_topk(doc, sc, a[7], a[8], a[9])
        return chain

    sp.update(sparse_merge_timings(stream_sparse.stream_sparse_topk,
                            stream_sparse.stream_sparse_topk_plain, chain_of(a), a, {}))
    sp.update(merge_bound(a))
    d = deep["args"]
    sp["deepest_pool"] = {
        "shape": list(d[6].shape), "k": d[7],
        **sparse_merge_timings(stream_sparse.stream_sparse_topk,
                        stream_sparse.stream_sparse_topk_plain, chain_of(d), d, {}),
        "bound_ms": merge_bound(d)["bound_ms"],
    }
    (doc, sc), s3_err, s3_ms, s3_plain = held_pair(
        stream_sparse.stream_sparse_decode, stream_sparse.stream_sparse_decode_plain,
        (*a[:7], a[8]), "(i) S3",
    )
    df, perm = torch.sort(doc, dim=1, stable=True)
    s4 = s4_fields((df, sc.gather(1, perm), n, a[9]), "(i)")
    del doc, sc, df, perm
    s3 = {"ms": s3_ms, "plain_ms": s3_plain, **decode_bound(a), "library_ms": None,
          "max_abs_err": s3_err}
    dp = sp["deepest_pool"]
    print(
        f"(i) SP-stream stream_sparse_topk: {sp['checked']} dispatches equal to the plain "
        f"version (torch.equal, pad ids included); largest {tuple(a[6].shape)} windows "
        f"({sp['size']} lanes, k={a[7]}, {a[10].shape[1] - 1} segments) {sp['ms']:.4f} ms "
        f"on the card ({sp['launch_paced_ms']:.4f} back to back), bound "
        f"{sp['bound_ms']:.4f} ms ({sp['bound_bytes']} B); the parent's chain S3 -> sort "
        f"-> S4 -> select_keys {sp['parent_chain_ms']:.4f} ms on the card "
        f"({sp['parent_chain_launch_paced_ms']:.4f} back to back; device memory a call "
        f"takes: SP-stream {sp['peak_extra_bytes']} B, the chain "
        f"{sp['parent_chain_peak_extra_bytes']} B): S3 alone {s3_ms:.4f} "
        f"(bound {s3['bound_ms']:.4f}), S4 alone {s4['ms']:.4f} (bound {s4['bound_ms']:.4f}); "
        f"plain {sp['plain_ms']:.4f} ms [{label}]"
    )
    print(
        f"(i) SP-stream on the deepest pool's dispatch {tuple(dp['shape'])}, k={dp['k']}: "
        f"{dp['ms']:.4f} ms on the card ({dp['launch_paced_ms']:.4f} back to back), bound "
        f"{dp['bound_ms']:.4f}; the parent's chain {dp['parent_chain_ms']:.4f} ms "
        f"({dp['parent_chain_launch_paced_ms']:.4f} back to back) [{label}]"
    )
    s5.update(s5_fields(s5["args"]))
    s5.update(rescore_bound(s5["args"]))
    sb = s5["scores_bound"]
    print(
        f"(i) S5 rescore_topk on its largest dispatch {s5['shape']}, "
        f"{len(scores_held)} scores-only calls == stream_rescore_plain too: "
        f"{s5['ms']:.4f} ms device ({s5['launch_paced_ms']:.4f} back to back), "
        f"bound {s5['bound_ms']:.4f} ms ({s5['bound_bytes']} B); the scores-only "
        f"launch {s5['scores_ms']:.4f} ms device ({s5['scores_launch_paced_ms']:.4f} "
        f"back to back), bound {sb['bound_ms']:.4f} ms ({sb['bound_bytes']} B); "
        f"scores then lex_topk {s5['pair_ms']:.4f} ms device "
        f"({s5['pair_launch_paced_ms']:.4f} back to back); torch.topk on the "
        f"packed keys {s5['library_ms']:.4f} ms device "
        f"({s5['library_launch_paced_ms']:.4f} back to back); plain "
        f"{s5['plain_ms']:.4f} ms [{label}]"
    )
    sp["args"] = s5["args"] = a = d = deep["args"] = None

    # The main path at scale: every count from 0, 5 batches of each mix.
    stream_sparse.DECODE_LAUNCHES = stream_sparse.COMBINE_LAUNCHES = 0
    stream_sparse.MERGE_LAUNCHES = stream_rescore.LAUNCHES = 0
    heavy_stats = None
    single = {}  # each mix's last results, which phase (w) is held to
    for mix, queries in batches.items():
        qps = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            results = index.search_batch(queries, K)
            qps.append(len(queries) / (time.perf_counter() - t0))
        if len(results) != len(queries) or not all(
            np.isfinite(h.score) and h.score > 0 for hits in results for h in hits
        ):
            raise AssertionError(f"{mix} results are not finite positive hits")
        single[mix] = hits_of(results)
        st = engine.last_ms_stats
        if mix == "heavy":
            heavy_stats = st
        print(
            f"(i) {mix}: {ROUNDS} x search_batch({len(queries)} queries, k={K}) "
            f"at {seg.n_docs} docs; QPS per batch {[round(x, 1) for x in qps]} "
            f"(median {float(np.median(qps)):.1f}) [{label}]"
        )
        print(f"(i) {mix} last_ms_stats: {json.dumps(st)}")
    launches = {
        "stream_sparse_topk": stream_sparse.MERGE_LAUNCHES,
        "stream_rescore": stream_rescore.LAUNCHES,
    }
    old = (stream_sparse.DECODE_LAUNCHES, stream_sparse.COMBINE_LAUNCHES)
    if not all(launches.values()) or any(old):
        raise AssertionError(f"launches on the path: {launches}; S3 and S4 {old}")
    if not heavy_stats or heavy_stats["routed_queries"] <= 0:
        raise AssertionError(f"auto routed no heavy query to MaxScore: {heavy_stats}")
    print(f"(i) launches over the timed batches: {launches}; S3 and S4 none")
    for mix, queries in batches.items():
        planning_host_ms(
            lambda: index.search_batch(queries, K), stream_mod, f"(i) {mix}", label
        )
    prof = device_profile(
        lambda: index.search_batch(batches["heavy"], K), "(i) heavy profile", label,
        track=("sparse_merge", "stream_rescore", "adix", "sbtopk", "mbtopk"),
        expect={
            "sparse_merge": lambda: stream_sparse.MERGE_LAUNCHES,
            "stream_rescore": lambda: stream_rescore.LAUNCHES,
        },
    )
    if not prof or any(prof["tracked"][x]["launches"] for x in ("adix", "sbtopk", "mbtopk")):
        raise AssertionError(f"(i) a sort or top-k of torch in the heavy batch: {prof['tracked']}")
    heavy = calls_device_ms(
        lambda: index.search_batch(batches["heavy"], K), stream_mod,
        ("stream_sparse_topk", "rescore_topk"),
    )
    sp["heavy_batch_ms"], sp["heavy_batch_calls"] = heavy["stream_sparse_topk"]
    print(
        f"(i) heavy batch, each call timed again on its inputs on the card: SP-stream "
        f"{sp['heavy_batch_ms']:.4f} ms in {sp['heavy_batch_calls']} calls, S5 "
        f"{heavy['rescore_topk'][0]:.4f} ms in {heavy['rescore_topk'][1]} calls [{label}]"
    )

    # (j) card == CPU-plain for each strategy, recall, memory
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 4)
    half = SPARSE_AUDIT // 2
    sample = [
        q
        for queries in batches.values()
        for q in (queries[i] for i in np.sort(rng.choice(len(queries), half, replace=False)))
    ]
    payload = np.asarray(seg.doc_payload)
    deleted = doomed(payload)
    fmask = keep(payload)
    for strategy in ("auto", "sparse", "maxscore"):
        gpu = engine if strategy == "auto" else StreamEngine(
            seg, stream=si, strategy=strategy, device="cuda"
        )
        cpu = StreamEngine(seg, stream=si, strategy=strategy, device="cpu")
        for step in ("as built", "1% deleted", "1% deleted + prefilter"):
            if step == "1% deleted":
                gpu.set_deleted(deleted)
                cpu.set_deleted(deleted)
            kw = {"filter_mask": fmask} if "prefilter" in step else {}
            restore, held = _checked(
                stream_mod, "stream_sparse_topk", stream_sparse.stream_sparse_topk_plain,
                lambda a: a[6].numel(), lambda out, want: 0.0,
            )
            try:
                got = gpu.search(sample, K, **kw)
            finally:
                restore()
            want = cpu.search(sample, K, **kw)
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{strategy}, {step}: GPU != CPU-plain")
            if gpu.last_ms_stats != cpu.last_ms_stats:
                raise AssertionError(f"{strategy}, {step}: last_ms_stats differ")
            scores, ids, pays = got
            hits = [
                [(float(s), int(p)) for s, i, p in zip(*row) if i >= 0]
                for row in zip(scores, ids, pays)
            ]
            if step != "as built":
                bad = [p for row in hits for _, p in row if doomed(p) or (kw and not keep(p))]
                if bad:
                    raise AssertionError(f"deleted or filtered payloads returned: {bad[:5]}")
            elif strategy == "auto":
                picks = list(range(0, RECALL_QUERIES // 2)) + list(
                    range(half, half + RECALL_QUERIES // 2)
                )
                recall, total, ties = recall_vs_oracle(
                    seg, [sample[i] for i in picks], [hits[i] for i in picks], K
                )
                if recall != 1.0:
                    raise AssertionError(f"recall@{K} vs oracle {recall} != 1.0")
            st = gpu.last_ms_stats
            print(
                f"(j) {strategy}, {step}: GPU == CPU-plain on {len(sample)} "
                f"queries ({sum(map(len, hits))} hits; routed "
                f"{st and st['routed_queries']}, fallback {st and st['fallback_queries']}); "
                f"{held['checked']} SP-stream calls == plain"
            )
        if strategy != "auto":
            del gpu, cpu
    want_bytes = si.words.nbytes + 4 * (si.n_docs + 1) + 14 * (si.n_windows + 1)
    got_bytes = engine.memory_report()["total"]
    if got_bytes != want_bytes:
        raise AssertionError(f"memory_report total {got_bytes} != {want_bytes}")
    print(
        f"(j) recall@{K} vs the float64 oracle {recall} on {RECALL_QUERIES} "
        f"queries ({total} hits, {ties} boundary ties excused); memory_report "
        f"total {got_bytes} B == stream host arrays; (j) took "
        f"{time.perf_counter() - t0:.1f} s"
    )
    del index, engine
    exact_entries, s4_exact = exact_sparse(args, seg, batches, label, build_times)
    b1_large = blockmax_large(args, seg, batches["informative"], label, build_times)
    sharded = sharded_large(
        args, seg, batches, single, keys, doc_ids, tfs, doc_start, label, build_times
    )
    del keys, doc_ids, tfs, doc_start

    def entry(name, source, replaces, fields, by_phase, **extra):
        return {
            "name": name,
            "route": "cuda",
            "source": f"vectorchord_bm25_tpu_torch/csrc/{source}",
            "replaces": f"vectorchord_bm25_tpu/search/{replaces}",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": fields.get("max_abs_err", 0.0),
            **{key: fields[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "bound_bytes", "bound_ops")},
            "library_ms": fields.get("library_ms"),
            **extra,
        }

    entries = [
        entry(
            "stream_sparse_topk", "sparse_merge.cu", "stream.py:309", {**sp, "max_abs_err": sp["err"]},
            {"(i)": launches["stream_sparse_topk"]},
            **{key: sp[key] for key in ("launch_paced_ms", "parent_chain_ms",
                                        "parent_chain_launch_paced_ms", "peak_extra_bytes",
                                        "parent_chain_peak_extra_bytes", "deepest_pool",
                                        "heavy_batch_ms", "heavy_batch_calls")},
        ),
        entry("stream_sparse_decode", "stream_sparse.cu", "stream.py:327", s3, {"(i)": 0}),
        entry("sparse_combine", "stream_sparse.cu", "stream.py:337", s4,
              {"(i)": 0, "(r)": 0}, on_exact_lanes=s4_exact),
        entry(
            "stream_rescore", "stream_rescore.cu", "stream.py:366",
            {**s5, "max_abs_err": s5["err"]}, {"(i)": launches["stream_rescore"]},
            **{key: s5[key] for key in S5_EXTRA if key in s5},
        ),
    ]
    return entries + exact_entries, b1_large, sharded


def blockmax_large(args, seg, queries, label, build_times):
    """Phase (s): the Block-Max engine on phase (i)'s corpus, where a query's
    bound row has 16,384 ranges (64 KB of shared memory a block) and the
    default chunk is 256.  Returns B1's measured fields at that size, its
    launches and the rounds a batch."""
    import torch

    from vectorchord_bm25_tpu_torch.index.ranges import build_range_index
    from vectorchord_bm25_tpu_torch.ops import score_kernel
    from vectorchord_bm25_tpu_torch.search import blockmax
    from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine

    # Ranges of 128 docs, as at 131,072 docs: 16,384 of them here (the
    # default at this size is 256 docs a range, 8,192 ranges).
    t0 = time.perf_counter()
    ri = build_range_index(seg, range_size=128)
    build_times["(s) range index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = BlockMaxEngine(seg, ri, device="cuda")
    build_times["(s) Block-Max engine upload"] = time.perf_counter() - t0
    print(
        f"(s) Block-Max at {seg.n_docs} docs: {ri.n_ranges} ranges of "
        f"{ri.range_size}, chunk {engine.chunk}; range index host build "
        f"{build_times['(s) range index']:.1f} s; device index "
        f"{engine.memory_report()['total']} B"
    )
    firsts = []
    measured = b1_check(engine, queries, label, "(s)", select_inputs=firsts)
    # The engine's default at this size (ranges of 256 docs, 8,192 of them,
    # chunk 128) without a second range index: the first round's rows
    # folded pairwise by the max of neighbouring ranges (a valid bound of
    # the 256-doc range), through the same CSR.
    ub0, ts0, rest, kw = firsts[0]
    folded = ub0.view(ub0.shape[0], -1, 2).amax(dim=2).contiguous()
    kw8 = {**kw, "chunk": 128}
    held_select(
        blockmax.round_select, "(s) folded", folded.clone(), ts0, rest,
        torch.zeros(1, dtype=torch.int32, device="cuda"), kw8,
    )
    measured["round_select_r8192"] = select_fields(folded, ts0, rest, kw8)
    m = measured["round_select_r8192"]
    print(
        f"(s) round_select on the rows folded to R={folded.shape[1]}, C=128: == "
        f"plain (torch.equal); kernel {m['ms']:.4f} ms (launched back to back "
        f"{m['launch_paced_ms']:.4f}), plain {m['plain_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms ({m['bound_by']}), torch.topk {m['library_ms']:.4f} ms "
        f"(back to back {m['library_launch_paced_ms']:.4f}) [{label}]"
    )
    del ub0, folded, firsts
    score_kernel.LAUNCHES = 0
    b1_zero()
    qps, rounds = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        scores, ids, _ = engine.search(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
        rounds.append(engine.last_rounds)
    launches = b1_read()
    p1_launches = score_kernel.LAUNCHES
    if not all(launches.values()) or not p1_launches:
        raise AssertionError(f"(s) a kernel never launched: {launches}, P1 {p1_launches}")
    live = ids >= 0
    if not live.any() or not (np.isfinite(scores[live]).all() and (scores[live] > 0).all()):
        raise AssertionError("(s) results are not finite positive hits")
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 8)
    n_sample = min(RECALL_QUERIES, len(queries))
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), n_sample, replace=False))]
    cpu = BlockMaxEngine(seg, ri, device="cpu")
    n_rounds = rounds_equal(engine, cpu, sample, "(s)")
    del cpu
    print(
        f"(s) 3 x BlockMaxEngine.search({len(queries)} queries, k={K}); rounds a "
        f"batch {rounds}; P1 {p1_launches} launches, B1 {launches}; QPS per batch "
        f"{[round(x, 1) for x in qps]}; GPU == CPU-plain on {n_sample} queries "
        f"(last_rounds {n_rounds} on both; {time.perf_counter() - t0:.1f} s) [{label}]"
    )
    return {"measured": measured, "launches": launches, "p1_launches": p1_launches,
            "rounds": rounds}


# ---------------------------------------------------------------------------
# Phases (u)-(w): the sharded index on the card.

SHARDS = 8
SHARD_ROUNDS = 3
SHARD_MODES = (
    ("stream", {}),
    ("exact", {}),
    ("hybrid", {}),
    ("hybrid", {"memory_mode": "compact"}),
    ("blockmax", {}),
    ("blockmax", {"posting_mode": "tf"}),
)
# Where the port's new kernels replace the reference: the collective merge
# of the sharded bodies, the global statistics step, the device build's sort.
SHARD_REPLACES = {
    "shard_merge": "vectorchord_bm25_tpu/parallel/shard.py:820",
    "shard_stats": "vectorchord_bm25_tpu/parallel/shard.py:2285",
    "posting_sort": "vectorchord_bm25_tpu/parallel/devbuild.py:244",
}
# Entries of kernels measured before (u) whose launches had no phase split.
FIRST_PHASE = {
    "stream_dense_accumulate": "(f)",
    "fused_range_scores_bf16": "(l)",
    "tf_range_scores": "(m)",
}


def mode_name(engine, opts):
    return engine + "".join(f" {v}" for v in opts.values())


def cpu_twin(index):
    """The same sharded index on the CPU, where every kernel is its plain
    version: a shallow copy whose tensors are copied to the CPU (its host
    state, segments and stream indexes are shared, so no rebuild)."""
    import copy

    import torch

    from vectorchord_bm25_tpu_torch.index.growing import GrowingSegment
    from vectorchord_bm25_tpu_torch.parallel.shard import _GlobalStats

    if len(index.growing):
        raise AssertionError("cpu_twin copies no growing segment")
    twin = copy.copy(index)
    for name, value in vars(index).items():
        if isinstance(value, torch.Tensor):
            setattr(twin, name, value.cpu())
    twin.device = torch.device("cpu")
    twin.growing = GrowingSegment(_GlobalStats(twin), device="cpu")
    return twin


def sharded_hits(results):
    """(scores, ids, payloads) arrays as hit lists of (score, payload)."""
    scores, ids, pays = results
    return [
        [(float(s), int(p)) for s, i, p in zip(*row) if i >= 0]
        for row in zip(scores, ids, pays)
    ]


def same_results(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def shard_checks(engine, opts):
    """The kernels a sharded body launches, as ``_checked`` specs (module,
    name, plain, size, errs), their launch counters (module, counter) and
    whether the path must call them, by kernel name.  B1 is held by
    ``b1_check``.  Under ``strategy="maxscore"`` SP-stream and S5 must run;
    S1, S2 and SH-merge run only for a query some shard fails to certify."""
    from vectorchord_bm25_tpu_torch.ops import (
        exact_kernel, score_kernel, shard_kernels, stream_kernel, stream_rescore,
        stream_sparse, topk,
    )
    from vectorchord_bm25_tpu_torch.parallel import shard
    from vectorchord_bm25_tpu_torch.search import blockmax

    def first_err(out, want):
        return _finite_err(out[0], want[0])

    def merged_err(out, want):
        return _finite_err(*(shard_kernels.merged_pair(x)[0] for x in (out, want)))

    ms = opts.get("strategy") == "maxscore"
    specs = {
        "shard_merge": (
            (shard, "shard_merge", shard_kernels.shard_merge_plain,
             lambda a: a[0].numel(), merged_err),
            (shard_kernels, "MERGE_LAUNCHES"), not ms,
        ),
    }
    if engine in ("exact", "hybrid", "stream"):
        def s2_plain(*a, out=None, **kw):
            return topk.dense_topk_plain(*a, **kw)  # the kernel wrote into out

        specs["dense_topk"] = (
            (shard, "dense_topk", s2_plain, lambda a: a[0].numel(), first_err),
            (topk, "LAUNCHES"), not ms,
        )
    if engine == "stream":
        specs["stream_dense_accumulate"] = (
            (shard, "stream_dense_accumulate", stream_kernel.stream_dense_accumulate_plain,
             lambda a: a[6].numel(), _finite_err),
            (stream_kernel, "LAUNCHES"), not ms,
        )
        if ms:
            specs["stream_sparse_topk"] = (
                (shard, "stream_sparse_topk", stream_sparse.stream_sparse_topk_plain,
                 lambda a: a[6].numel(), first_err),
                (stream_sparse, "MERGE_LAUNCHES"), True,
            )
            specs["stream_rescore"] = (
                (shard, "rescore_topk", rescore_plain_held("(w)", []),
                 lambda a: a[6].numel(), first_err),
                (stream_rescore, "LAUNCHES"), True,
            )
    elif engine in ("exact", "hybrid") and opts.get("memory_mode") != "compact":
        specs["exact_dense_accumulate"] = (
            (shard, "exact_dense_accumulate", exact_kernel.exact_dense_accumulate_plain,
             lambda a: a[3].numel(), _finite_err),
            (exact_kernel, "DENSE_LAUNCHES"), True,
        )
    elif engine == "hybrid":
        specs["exact_compact_accumulate"] = (
            (shard, "exact_compact_accumulate", exact_kernel.exact_compact_accumulate_plain,
             lambda a: a[4].numel(), _finite_err),
            (exact_kernel, "COMPACT_LAUNCHES"), True,
        )
    elif opts.get("posting_mode") == "tf":
        specs["tf_range_scores"] = (
            (blockmax, "tf_range_scores", score_kernel.tf_range_scores_plain,
             lambda a: a[6].numel(), _finite_err),
            (score_kernel, "TF_LAUNCHES"), True,
        )
    else:
        specs["fused_range_scores"] = (
            (blockmax, "fused_range_scores", score_kernel.fused_range_scores_plain,
             lambda a: a[2].numel(), _finite_err),
            (score_kernel, "LAUNCHES"), True,
        )
    return specs


def serve_sharded(index, opts, queries, phase, what, label, rounds=SHARD_ROUNDS):
    """One batch with every kernel call of ``index``'s path held against its
    plain version (``torch.equal``), then ``rounds`` batches with the launch
    counters from 0.  Returns (launches by kernel name, the checked stats
    by name, QPS per batch, the last results)."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import blockmax_round

    specs = shard_checks(index.engine, opts)
    checks = {name: _checked(*spec) for name, (spec, _, _) in specs.items()}
    counters = {name: counter for name, (_, counter, _) in specs.items()}
    required = {name for name, (_, _, must) in specs.items() if must}
    if index.engine == "blockmax":
        counters.update({n: (blockmax_round, c) for n, c in zip(B1_NAMES, B1_COUNTERS)})
        required.update(B1_NAMES)
    try:
        if index.engine == "blockmax":
            b1_check(index, queries, label, phase)
        else:
            index.search(queries, K)
    finally:
        for restore, _ in checks.values():
            restore()
    stats = {name: st for name, (_, st) in checks.items()}
    checked = {n: st["checked"] for n, st in stats.items()}
    if not all(checked[n] for n in required if n in checked):
        raise AssertionError(f"{phase} {what}: a kernel of the path saw no call: {checked}")

    index.search(queries, K)  # warm-up
    torch.cuda.synchronize()
    for module, counter in counters.values():
        setattr(module, counter, 0)
    qps = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        results = index.search(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
    launches = {name: getattr(m, c) for name, (m, c) in counters.items()}
    if not all(launches[n] for n in required):
        raise AssertionError(f"{phase} {what}: a kernel of the path never launched: {launches}")
    scores, ids, _ = results
    live = ids >= 0
    if not live.any() or not (np.isfinite(scores[live]).all() and (scores[live] > 0).all()):
        raise AssertionError(f"{phase} {what}: results are not finite positive hits")
    print(
        f"{phase} {what}: every call equal to its plain version (torch.equal), calls "
        f"checked {checked}; {rounds} x search({len(queries)} queries, k={K}); launches "
        f"{launches}; QPS per batch {[round(x, 1) for x in qps]} (median "
        f"{float(np.median(qps)):.1f}) [{label}]"
    )
    return launches, stats, qps, results


def sharded_build(keys, doc_ids, tfs, doc_start, phase, label, timed=False):
    """``ShardedIndex.build_from_postings(..., SHARDS, device="cuda",
    device_build=True)``: D1-sort held ``torch.equal`` to its plain version
    on all six columns, SH-stats to its plain version and to the host's
    offsets.  Returns (index, host seconds by step, launches of D1-sort and
    SH-stats, D1-sort's check (with its unsorted input columns if
    ``timed``), SH-stats' checked stats)."""
    import torch

    from vectorchord_bm25_tpu_torch import ShardedIndex
    from vectorchord_bm25_tpu_torch.models.fieldnorm import FIELDNORM_TO_LENGTH
    from vectorchord_bm25_tpu_torch.ops import shard_kernels
    from vectorchord_bm25_tpu_torch.parallel import devbuild, shard

    secs = {"packing": 0.0, "sort": 0.0, "flush": 0.0, "index upload": 0.0}
    real = {
        "cols": devbuild._postings_to_shard_cols,
        "sort": devbuild.posting_sort,
        "flush": devbuild.build_sealed_segment_from_postings,
        "init": ShardedIndex._init_from_shards,
    }
    sort = {"checked": 0, "input": None, "shape": None, "passes": None}

    def clocked(step, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[step] += time.perf_counter() - t0
            return out
        return run

    def checked_sort(cols):
        unsorted = [c.clone() for c in cols]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real["sort"](cols)
        torch.cuda.synchronize()
        secs["sort"] += time.perf_counter() - t0
        sort["passes"] = shard_kernels.SORT_PASSES
        want = shard_kernels.posting_sort_plain(unsorted)
        torch.cuda.synchronize()
        if not all(torch.equal(c, w) for c, w in zip(cols, want)):
            raise AssertionError(f"{phase} posting_sort != its plain version")
        del want
        sort["checked"] += 1
        sort["shape"] = tuple(cols[0].shape)
        sort["input"] = unsorted if timed else None
        return cols

    restore_stats, stats_check = _checked(
        devbuild, "shard_stats", shard_kernels.shard_stats_plain,
        lambda a: a[0].numel(), lambda o, w: 0.0,
    )
    devbuild._postings_to_shard_cols = clocked("packing", real["cols"])
    devbuild.posting_sort = checked_sort
    devbuild.build_sealed_segment_from_postings = clocked("flush", real["flush"])
    ShardedIndex._init_from_shards = clocked("index upload", real["init"])
    shard_kernels.SORT_LAUNCHES = shard_kernels.STATS_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        index = ShardedIndex.build_from_postings(
            keys, doc_ids, tfs, doc_start, SHARDS, device="cuda", device_build=True,
        )
    finally:
        restore_stats()
        devbuild._postings_to_shard_cols = real["cols"]
        devbuild.posting_sort = real["sort"]
        devbuild.build_sealed_segment_from_postings = real["flush"]
        ShardedIndex._init_from_shards = real["init"]
    secs["total"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"posting_sort": shard_kernels.SORT_LAUNCHES}
    if not (sort["checked"] and stats_check["checked"] and launches["posting_sort"]
            and shard_kernels.STATS_LAUNCHES):
        raise AssertionError(f"{phase} the device build skipped D1-sort or SH-stats")

    # SH-stats against the host: (N, sum dl) and the offsets.
    restore_stats, stats_step = _checked(
        shard, "shard_stats", shard_kernels.shard_stats_plain,
        lambda a: a[0].numel(), lambda o, w: 0.0,
    )
    try:
        n, sdl, _ = index.global_stats_step()
    finally:
        restore_stats()
    launches["shard_stats"] = shard_kernels.STATS_LAUNCHES
    host_sdl = sum(int(FIELDNORM_TO_LENGTH[v.segment.doc_fieldnorm].sum()) for v in index.views)
    counts = np.array([v.segment.n_docs for v in index.views])
    host_off = np.cumsum(counts) - counts
    if n != doc_start.size - 1 or sdl != host_sdl or not np.array_equal(index.doc_offsets, host_off):
        raise AssertionError(f"{phase} SH-stats {(n, sdl)} != host {(doc_start.size - 1, host_sdl)}")
    print(
        f"{phase} device build: {SHARDS} shards of {counts.tolist()} docs; D1-sort on "
        f"{sort['shape']} columns == its plain version (torch.equal, all six; "
        f"{sort['passes']} radix passes, as the wrapper reports); SH-stats == "
        f"its plain version and the host's (N {n}, sum dl {sdl}, offsets "
        f"{host_off.tolist()}); host seconds: "
        + "; ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; peak device memory {peak} B [{label}]"
    )
    return index, secs, launches, sort, stats_step


def segments_equal_host(index, keys, doc_ids, tfs, doc_start, phase):
    """The device-built shards equal ``device_build=False``'s: every array
    tests/test_sharded_mutation.py:255-268 compares."""
    from vectorchord_bm25_tpu_torch import build_sealed_segment_from_postings

    n = doc_start.size - 1
    bounds = np.linspace(0, n, SHARDS + 1).astype(np.int64)
    for i, view in enumerate(index.views):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        p0, p1 = int(doc_start[lo]), int(doc_start[hi])
        host = build_sealed_segment_from_postings(
            keys[p0:p1], np.asarray(doc_ids[p0:p1], dtype=np.int64) - lo,
            np.asarray(tfs[p0:p1], dtype=np.int64), hi - lo,
            payloads=np.arange(lo, hi), doc_grouped=True,
        )
        dev = view.segment
        if (host.n_docs, host.sum_dl) != (dev.n_docs, dev.sum_dl) or not all(
            np.array_equal(getattr(host, f), getattr(dev, f))
            for f in ("token_keys", "token_df", "block_docids", "block_tfs",
                      "doc_fieldnorm", "block_wand_fn", "block_wand_tf")
        ):
            raise AssertionError(f"{phase} shard {i}: device build != host build")
    print(f"{phase} the {SHARDS} device-built segments == device_build=False's (every array)")


def sharded_restart(index, queries, new_docs, label):
    """Phase (u)'s restart of the stream sharded index: save, open with the
    WAL attached, 1,024 inserts and 1% deleted through it, a prefilter,
    maintain, drop it, open again (the WAL replays), each result equal to
    the live index after the same mutations."""
    import os
    import tempfile

    import torch

    from vectorchord_bm25_tpu_torch import open_sharded_index, save_sharded_index

    def clock(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check(opened, what, **kw):
        if not same_results(opened.search(queries, K, **kw), index.search(queries, K, **kw)):
            raise AssertionError(f"(u) restart: {what}: the opened index != the live index")

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded")
        _, times["save"] = clock(save_sharded_index, index, path)
        size_1 = dir_bytes(path)
        opened, times["open"] = clock(open_sharded_index, path, device="cuda")
        if opened.device.type != "cuda" or opened.n_shards != index.n_shards:
            raise AssertionError(f"(u) restart: opened on {opened.device}")
        check(opened, "save + open")
        base = int(index.global_payloads.max()) + 1
        t0 = time.perf_counter()
        for j, doc in enumerate(new_docs):
            opened.insert(doc, base + j)
        n_del = opened.bulkdelete(doomed)
        times[f"{len(new_docs)} inserts + 1 delete, each fsynced"] = time.perf_counter() - t0
        for j, doc in enumerate(new_docs):
            index.insert(doc, base + j)
        if index.bulkdelete(doomed) != n_del or not n_del:
            raise AssertionError("(u) restart: bulkdelete counts differ or deleted nothing")
        check(opened, "inserts + deletes")
        check(opened, "a prefilter", filter_fn=keep)
        _, times["maintain"] = clock(opened.maintain)
        index.maintain()
        check(opened, "maintain")
        wal_bytes = os.path.getsize(os.path.join(path, "wal.log"))
        opened._wal.close()
        del opened
        again, times["open 2 (WAL replay)"] = clock(open_sharded_index, path, device="cuda")
        check(again, "the WAL replayed")
        got = sharded_hits(index.search(queries, K, filter_fn=keep))
        if any(doomed(p) or not keep(p) for hits in got for _, p in hits):
            raise AssertionError("(u) restart: a deleted or filtered payload came back")
        n_new = sum(p >= base for hits in got for _, p in hits)
        _, times["save 2"] = clock(save_sharded_index, again, path)
        if os.path.getsize(os.path.join(path, "wal.log")):
            raise AssertionError("(u) restart: the WAL is not empty after a checkpoint")
        size_2 = dir_bytes(path)
        again._wal.close()
    print(
        f"(u) stream sharded restart: save + open == the live index; {len(new_docs)} "
        f"inserts and {n_del} deletes through the WAL ({wal_bytes} B), a prefilter "
        f"({n_new} hits of inserted docs), maintain, reopened with the WAL replayed: == "
        f"the live index; {size_1} B on disk, {size_2} B after maintain + save"
    )
    print("(u) restart host times: " + "; ".join(
        f"{k} {v:.2f} s" for k, v in times.items()) + f" [{label}]")


def sharded_slice(args, seg, queries, keys, doc_ids, tfs, doc_start, label, build_times):
    """Phase (u): the sharded index on the 131,072-doc corpus (phase (d)'s
    postings, 8 shards).  Returns launches by kernel name and phase, S2
    timed on one shard's accumulator (its flat branch), and SH-merge timed
    on each body's largest call with its dispatch census."""
    import torch

    from vectorchord_bm25_tpu_torch import Document, IndexOptions, ShardedIndex

    t0 = time.perf_counter()
    built, secs, build_launches, _, _ = sharded_build(keys, doc_ids, tfs, doc_start, "(u)", label)
    segments_equal_host(built, keys, doc_ids, tfs, doc_start, "(u)")
    build_times["(u) device build"] = secs["total"]
    shards = [v.segment for v in built.views]
    launches = {name: {"(u) build": n} for name, n in build_launches.items()}
    rng = np.random.default_rng(args.seed + 10)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    stream_index = None
    merge_u = {}
    for engine, opts in SHARD_MODES:
        what = mode_name(engine, opts)
        if engine == "stream":
            index = built
        else:
            index = ShardedIndex(shards, IndexOptions(), device="cuda", engine=engine, **opts)
        got, stats, _, _ = serve_sharded(index, opts, queries, "(u)", what, label)
        merge_u[what] = {
            **merge_timings(stats["shard_merge"], label, f"(u) {what}"),
            "census": merge_census(index, queries, what, label),
        }
        if engine == "stream":
            # S2's flat branch: one shard's accumulator, below 2^17 docs.
            acc, kk, n_docs = stats["dense_topk"]["args"]
            s2_flat = s2_fields(acc, kk, n_docs)
            print(
                f"(u) {what}: S2 on one shard's [{acc.shape[0]}, {acc.shape[1]}] "
                f"accumulator (n_docs {n_docs}, k={kk}, hierarchical "
                f"{s2_flat['hierarchical']}): kernel {s2_flat['ms']:.4f} ms on the card "
                f"({s2_flat['launch_paced_ms']:.4f} back to back), plain "
                f"{s2_flat['plain_ms']:.4f} ms, torch.topk {s2_flat['library_ms']:.4f} ms, "
                f"bound {s2_flat['bound_ms']:.4f} ms [{label}]"
            )
            del acc
        del stats
        for name, n in got.items():
            launches.setdefault(name, {})[f"(u) {what}"] = n
        cpu = cpu_twin(index)
        results = index.search(sample, K)
        if not same_results(results, cpu.search(sample, K)):
            raise AssertionError(f"(u) {what}: GPU != the CPU-plain sharded index")
        recall, total, ties = recall_vs_oracle(seg, sample, sharded_hits(results), K)
        if recall != 1.0:
            raise AssertionError(f"(u) {what}: recall@{K} vs oracle {recall} != 1.0")
        print(
            f"(u) {what}: GPU == CPU-plain sharded index on {AUDIT} queries; recall@{K} "
            f"vs the float64 oracle {recall} ({total} hits, {ties} ties excused); "
            f"device index {index.memory_report()['total']} B"
        )
        if engine == "stream":
            stream_index = index
        del index, cpu
    picks = rng.choice(seg.n_docs, 1024, replace=False)
    new_docs = [
        Document(
            keys=keys[int(doc_start[d]) : int(doc_start[d + 1])],
            values=tfs[int(doc_start[d]) : int(doc_start[d + 1])],
        )
        for d in picks
    ]
    sharded_restart(stream_index, queries, new_docs, label)
    build_times["(u) all of it"] = time.perf_counter() - t0
    del stream_index, built
    torch.cuda.empty_cache()
    return launches, s2_flat, merge_u


def sort_timings(sort, label):
    """D1-sort at phase (v)'s size, on the rows the build staged (doc-grouped,
    pads at the tail: the doc passes skipped) and on the same rows with every
    row shuffled by one fixed permutation (every pass run): the kernel held
    ``torch.equal`` to its plain version on the shuffled rows, then timed
    beside its plain version and the five chained stable ``torch.sort``
    passes that order the same rows (CUDA events, each run on a fresh copy
    of the columns), with the radix passes the wrapper reports and the peak
    device memory of the kernel's calls."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import shard_kernels

    staged = sort["input"]
    d, p = staged[0].shape
    perm = torch.randperm(p, generator=torch.Generator().manual_seed(p)).cuda()
    shuffled = [c[:, perm].contiguous() for c in staged]
    del perm
    work = [c.clone() for c in staged]

    def timed(fn, source, iters):
        total = 0.0
        for _ in range(iters):
            for w, u in zip(work, source):
                w.copy_(u)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def five_sorts():
        # The plain version's five stable passes, without its final gathers.
        perm = None
        for col in (4, 3, 2, 1, 0):
            key = work[col].long() if col == 4 else work[col].long() & 0xFFFFFFFF
            if perm is not None:
                key = key.gather(1, perm)
            order = key.sort(dim=1, stable=True).indices
            perm = order if perm is None else perm.gather(1, order)
        return perm

    def kernel():
        shard_kernels.posting_sort(work)

    # The shuffled rows: the kernel against its plain version first.
    for w, u in zip(work, shuffled):
        w.copy_(u)
    want = shard_kernels.posting_sort_plain(work)
    kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(work, want)):
        raise AssertionError("(v) posting_sort != its plain version on the shuffled rows")
    del want
    out = {}
    for name, source in (("staged", staged), ("shuffled", shuffled)):
        timed(kernel, source, 1)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = timed(kernel, source, 3)
        out[name] = {
            "ms": ms,
            "scatter_passes": shard_kernels.SORT_PASSES,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
            "library_ms": timed(five_sorts, source, 2),
        }
    plain_ms = timed(lambda: shard_kernels.posting_sort_plain(work), staged, 2)
    fields = {
        **out["staged"], "plain_ms": plain_ms, "shuffled": out["shuffled"],
        # The six columns read once and written once; a comparison sort
        # needs p log2 p comparisons a row.
        **bound(2 * 6 * 4 * d * p, d * p * int(np.log2(p))),
    }
    for name, m in out.items():
        print(
            f"(v) D1-sort on [{d}, {p}] x 6 columns, {name} rows: kernel {m['ms']:.3f} ms "
            f"in {m['scatter_passes']} radix passes (the wrapper's count), five chained "
            f"stable torch.sort {m['library_ms']:.3f} ms, bound {fields['bound_ms']:.4f} ms "
            f"({fields['bound_by']}); the kernel's calls took {m['peak_extra_bytes']} B of "
            f"device memory above the columns [{label}]"
        )
    print(f"(v) D1-sort's plain version on the staged rows: {plain_ms:.3f} ms [{label}]")
    del work, shuffled
    return fields


def stats_timings(index, st, label):
    """SH-stats at phase (v)'s size: kernel, plain, ``torch.sum`` of the f64
    lengths."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import shard_kernels

    a = (index.dev_doc_fn, index.dev_doc_live, index.dev_n_local)
    table = shard_kernels._length_table(torch.device("cuda"))  # on the card since (v)
    lengths = table[a[0].long()] * a[1].double()
    d, m = a[0].shape
    out = {
        "ms": device_ms(lambda: shard_kernels.shard_stats(*a)),
        "plain_ms": device_ms(lambda: shard_kernels.shard_stats_plain(*a)),
        "library_ms": device_ms(lambda: torch.sum(lengths, dim=1)),
        "launch_paced_ms": cuda_ms(lambda: shard_kernels.shard_stats(*a)),
        "max_abs_err": st["err"],
        # fieldnorm (1 B) and live flag (4 B) read a slot; a multiply and an
        # add a slot.
        **bound(5 * d * m + 8 * d + 8 * d + 8 * (d + 1), 2 * d * m),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
    }
    # The grid of the last launch, as the launcher passed it to the card.
    out["grid"] = list(shard_kernels.STATS_GRID)
    out["blocks"] = int(np.prod(out["grid"]))
    if out["blocks"] <= d:
        raise AssertionError(f"(v) SH-stats launched {out['grid']}: no more blocks than shards")
    ran = f"in a {out['grid']} grid ({out['blocks']} blocks)"
    print(
        f"(v) SH-stats on [{d}, {m}] {ran} on {out['sms']} SMs, "
        f"device time: kernel {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, torch.sum of the f64 lengths "
        f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); launched back to back by the host "
        f"{out['launch_paced_ms']:.4f} ms a call [{label}]"
    )
    return out


def merge_keys_of(a):
    """The packed keys SH-merge ranks, from one call's inputs (scores, ids,
    widths, offsets, kk): each shard's run rebased as the reference's
    ``g_ids``, ``[Q, sum of the widths]`` int64."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import shard_kernels

    scores, ids, widths, offsets, _ = a
    cols = []
    for d, w in enumerate(widths):
        s, i = scores[d, :, :w], ids[d, :, :w]
        g = torch.where(torch.isfinite(s), (i.long() + offsets[d]).int(), 2**31 - 1)
        cols.append(shard_kernels.merge_keys(s, g))
    return torch.cat(cols, dim=1)


def merge_timings(st, label, phase="(w)"):
    """SH-merge on one call's inputs, as a body handed them over (its
    largest call of ``phase``): kernel on the card and back to back, plain,
    ``torch.topk`` on the packed rebased keys, bound."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import shard_kernels

    a = st["args"]
    d, q, w = a[0].shape
    widths, kk = a[2], a[4]
    keys = merge_keys_of(a)
    kept = sum(min(x, kk) for x in widths)  # the entries a rank can keep
    out = {
        "ms": device_ms(lambda: shard_kernels.shard_merge(*a)),
        "plain_ms": device_ms(lambda: shard_kernels.shard_merge_plain(*a)),
        "library_ms": device_ms(
            lambda: torch.topk(keys, min(kk, keys.shape[1]), dim=1, largest=False)
        ),
        "launch_paced_ms": cuda_ms(lambda: shard_kernels.shard_merge(*a)),
        "library_launch_paced_ms": cuda_ms(
            lambda: torch.topk(keys, min(kk, keys.shape[1]), dim=1, largest=False)
        ),
        "max_abs_err": st["err"],
        # Each kept run entry (score and id) read once, the offsets, the
        # [2, Q, kk] output written once; a key a kept entry.
        **bound(8 * q * kept + 8 * d + 8 * q * kk, q * kept),
        "shape": [d, q, w],
        "widths": list(widths),
        "kk": kk,
    }
    print(
        f"{phase} SH-merge on [{d}, {q}, {w}] (widths {list(widths)}) -> [{q}, {kk}]: "
        f"kernel {out['ms']:.4f} ms on the card, {out['launch_paced_ms']:.4f} ms a call "
        f"launched back to back by the host; plain {out['plain_ms']:.4f} ms; torch.topk "
        f"on the packed keys {out['library_ms']:.4f} ms on the card, "
        f"{out['library_launch_paced_ms']:.4f} ms back to back; bound {out['bound_ms']:.5f} ms "
        f"({out['bound_by']}) [{label}]"
    )
    return out


def merge_census(index, queries, what, label):
    """One batch of ``index`` under ``torch.profiler``: its dispatches (the
    SH-merge launches, every one in the rows) and, a dispatch, torch's own
    kernels, fills and copies beside the port's, so that the merge's own
    launches show (one SH-merge launch and one copy to the host)."""
    from vectorchord_bm25_tpu_torch.ops import shard_kernels

    track = ("shard_merge_kernel", "at::native", "Memset", "Memcpy DtoH", "Memcpy HtoD")
    prof = device_profile(
        lambda: index.search(queries, K), f"(u) {what} dispatch census", label,
        track=track, expect={"shard_merge_kernel": lambda: shard_kernels.MERGE_LAUNCHES},
    )
    if prof is None:
        return None
    n = prof["tracked"]["shard_merge_kernel"]["launches"]
    if not n:
        raise AssertionError(f"(u) {what}: no SH-merge launch in the profiled batch")
    census = {name: prof["tracked"][name]["launches"] / n for name in track}
    print(
        f"(u) {what}: {n} dispatches a batch; a dispatch launches "
        + ", ".join(f"{name} x{x:g}" for name, x in census.items())
        + f" [{label}]"
    )
    return {"dispatches": n, "a_dispatch": census}


def held_to_single(got, single, what):
    """The reference's sharded-vs-single rule (tests/test_sharded.py:43-50):
    the same hit counts, a rank may hold another doc only where the two
    scores there are within 1e-4 (``rank_match``), scores within rtol 2e-5.
    Returns the number of such swaps."""
    return rule_swaps(sharded_hits(got), single, what)


def rule_swaps(got, single, what):
    """``held_to_single``'s rule on two lists of hit lists of (score,
    payload), e.g. two indexes of one corpus interned with different seeds.
    Returns the number of swaps."""
    swaps = 0
    for g, s in zip(got, single):
        if len(g) != len(s):
            raise AssertionError(f"{what}: {len(g)} hits, the single index {len(s)}")
        gs = np.array([x[0] for x in g], dtype=np.float64)
        ss = np.array([x[0] for x in s], dtype=np.float64)
        if not np.allclose(gs, ss, rtol=2e-5, atol=0.0):
            raise AssertionError(f"{what}: scores differ from the single index")
        for i, ((_, gp), (_, sp)) in enumerate(zip(g, s)):
            if gp != sp:
                if abs(gs[i] - ss[i]) >= 1e-4:
                    raise AssertionError(f"{what}: rank {i} holds {gp}, single {sp}")
                swaps += 1
    return swaps


def sharded_large(args, seg, batches, single, keys, doc_ids, tfs, doc_start, label, build_times):
    """Phases (v)-(w): the device build of phase (i)'s postings in 8 shards,
    then the sharded stream engine serving both 512-query mixes.  Returns
    (the kernels-line entries of SH-merge, SH-stats and D1-sort, launches
    by kernel name and phase)."""
    import torch

    from vectorchord_bm25_tpu_torch.ops import stream_rescore, stream_sparse
    from vectorchord_bm25_tpu_torch.parallel import shard

    # (v) the device build at scale
    index, secs, build_launches, sort, stats_st = sharded_build(
        keys, doc_ids, tfs, doc_start, "(v)", label, timed=True
    )
    build_times["(v) device build"] = secs["total"]
    launches = {name: {"(v) build": n} for name, n in build_launches.items()}
    sort_fields = sort_timings(sort, label)
    sort["input"] = None
    torch.cuda.empty_cache()
    stats_fields = stats_timings(index, stats_st, label)
    print(
        f"(v) {index.n_docs} docs in {SHARDS} shards (nmax {index._nmax}); stream "
        f"index on the card {index.memory_report()['total']} B"
    )

    # (w) serving: auto (dense per shard), then maxscore
    merge_st = None
    torch.cuda.reset_peak_memory_stats()
    for strategy in ("auto", "maxscore"):
        index.strategy = strategy
        for mix, queries in batches.items():
            what = f"stream {strategy}, {mix}"
            got, stats, _, results = serve_sharded(
                index, {"strategy": strategy}, queries, "(w)", what, label, rounds=ROUNDS
            )
            for name, n in got.items():
                launches.setdefault(name, {})[f"(w) {strategy} {mix}"] = n
            st = stats["shard_merge"]
            if st["checked"] and (merge_st is None or st["size"] > merge_st["size"]):
                merge_st = st
            swaps = held_to_single(results, single[mix], f"(w) {what}")
            if strategy == "maxscore":
                planning_host_ms(lambda: index.search(queries, K), shard, f"(w) {what}", label)
            if mix == "informative":
                device_profile(
                    lambda: index.search(queries, K), f"(w) {what} profile", label,
                    track=(
                        "dense_tiles_kernel", "FillFunctor", "dense_topk_select",
                        "sparse_merge", "stream_rescore", "adix", "sbtopk", "mbtopk",
                    ),
                    expect={
                        "sparse_merge": lambda: stream_sparse.MERGE_LAUNCHES,
                        "stream_rescore": lambda: stream_rescore.LAUNCHES,
                    },
                )
            print(
                f"(w) {what}: held to phase (i)'s single index on {len(queries)} queries "
                f"({swaps} swaps of tied scores); last_ms_stats "
                f"{json.dumps(index.last_ms_stats)}"
            )
    print(
        f"(w) peak device memory while serving: {torch.cuda.max_memory_allocated()} B "
        f"(one [q, nmax+1] accumulator a shard at a time)"
    )
    # The card against the CPU-plain sharded index, and the oracle.
    rng = np.random.default_rng(args.seed + 11)
    half = RECALL_QUERIES // 2
    sample = [
        q for queries in batches.values()
        for q in (queries[i] for i in np.sort(rng.choice(len(queries), half, replace=False)))
    ]
    cpu = cpu_twin(index)
    for strategy in ("auto", "maxscore"):
        index.strategy = cpu.strategy = strategy
        results = index.search(sample, K)
        if not same_results(results, cpu.search(sample, K)):
            raise AssertionError(f"(w) {strategy}: GPU != the CPU-plain sharded index")
    recall, total, ties = recall_vs_oracle(seg, sample, sharded_hits(results), K)
    if recall != 1.0:
        raise AssertionError(f"(w) recall@{K} vs oracle {recall} != 1.0")
    print(
        f"(w) GPU == CPU-plain sharded index on {len(sample)} queries (auto and "
        f"maxscore); recall@{K} vs the float64 oracle {recall} ({total} hits, "
        f"{ties} ties excused)"
    )
    del cpu, index
    torch.cuda.empty_cache()
    merge_fields = merge_timings(merge_st, label)
    by = {name: launches.pop(name) for name in ("shard_merge", "shard_stats", "posting_sort")}
    entries = []
    for name, fields in (
        ("shard_merge", merge_fields), ("shard_stats", stats_fields), ("posting_sort", sort_fields),
    ):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"vectorchord_bm25_tpu_torch/csrc/{name}.cu",
            "replaces": SHARD_REPLACES[name],
            "launches_by_phase": by[name],
            "max_abs_err": fields.pop("max_abs_err", 0.0),
            **fields,
        })
    return entries, launches


# Phase (x): the quality anchor of the reference's dataset harness, the
# generated msmarco-mini corpus (DESIGN.md: NDCG@10 0.703, recall@1000 1.0
# and 0 oracle rank-parity mismatches on the reference's CPU backend).
TEXT_SHAPE = "msmarco-mini"
TEXT_BATCH = 64
TEXT_SAMPLE = 64
REF_NDCG10, REF_RECALL1000 = 0.703, 1.0


def text_slice(label, build_times):
    """Phase (x): from raw text to ranked, evaluated results on the card.
    ``generate_streaming(TEXT_SHAPE)`` built out of core (``n_workers``
    spawned tokenizing workers, the native merge, the streaming flush), the
    served default on the card, ``run_dataset`` at k=1000 and k=10, S1 and
    S2 held to their plain versions on one k=1000 batch, 64 queries equal
    to the CPU, the float64 oracle's ranks, a save and an open.  Returns
    the launches of S1 and S2 in the timed runs, by kernel, the dataset and
    the index (phase (y) reuses both)."""
    import os
    import tempfile

    import torch

    from vectorchord_bm25_tpu_torch import Bm25Index, IndexOptions, open_index, save_index
    from vectorchord_bm25_tpu_torch.data import harness
    from vectorchord_bm25_tpu_torch.data.stream_synth import generate_streaming
    from vectorchord_bm25_tpu_torch.native import loader
    from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk
    from vectorchord_bm25_tpu_torch.parallel import hostbuild
    from vectorchord_bm25_tpu_torch.search import stream as port_stream

    if not loader.available():
        raise AssertionError(f"(x) the native library did not load: {loader.BUILD_ERROR}")
    t0 = time.perf_counter()
    ds = generate_streaming(TEXT_SHAPE)
    gen_s = time.perf_counter() - t0
    n_workers = min(8, os.cpu_count() or 1)
    stamps = {}

    def progress(stage, done, total):
        stamps[stage] = time.perf_counter()

    merges = []
    real_merge = hostbuild._merge_group

    def merge_group(group, out_path):
        merges.append(len(group))
        return real_merge(group, out_path)

    hostbuild._merge_group = merge_group
    loader.MERGES = 0
    t0 = time.perf_counter()
    try:
        index = harness.build_index_streaming(
            ds, engine="stream", n_workers=n_workers, device="cuda", progress=progress
        )
    finally:
        hostbuild._merge_group = real_merge
    t_flushed = time.perf_counter()
    engine = index.engine()
    torch.cuda.synchronize()
    t_up = time.perf_counter()
    if not merges or loader.MERGES != len(merges):
        raise AssertionError(
            f"(x) {len(merges)} merges, {loader.MERGES} of them native: every merge "
            f"must take the native merger"
        )
    if index.engine_kind != "stream" or not engine.dev_words.is_cuda:
        raise AssertionError(f"(x) the index serves {index.engine_kind} on {index.device}")
    seg = index.sealed
    times = {
        "scan": stamps["scan"] - t0,
        "merge": stamps["merge"] - stamps["scan"],
        "flush": t_flushed - stamps["merge"],
        "stream index and upload": t_up - t_flushed,
    }
    build_times["(x) generate, scan, merge, flush, upload"] = gen_s + t_up - t0
    n_postings = int(seg.token_df.sum())
    print(
        f"(x) {TEXT_SHAPE}: {seg.n_docs} docs, {ds.n_queries} queries, "
        f"{seg.n_tokens} terms, {n_postings} postings; out-of-core build in "
        f"{n_workers} workers, {len(merges)} merges of {merges} runs, all native "
        f"({loader.library_path()}); host s: queries generated {gen_s:.2f}, "
        + ", ".join(f"{name} {sec:.2f}" for name, sec in times.items())
        + f"; device index {engine.memory_report()['total']} B; engine "
        f"{type(engine).__name__}, strategy {engine.strategy} [{label}]"
    )

    queries = harness.make_queries(ds, index)
    stream_kernel.LAUNCHES = topk.LAUNCHES = 0
    run, metrics, qps_1000 = harness.run_dataset(
        ds, index, k=1000, batch=TEXT_BATCH, queries=queries
    )
    _, metrics_10, qps_10 = harness.run_dataset(
        ds, index, k=K, batch=TEXT_BATCH, queries=queries, rounds=3
    )
    launches = {
        "stream_dense_accumulate": stream_kernel.LAUNCHES, "dense_topk": topk.LAUNCHES,
    }
    if not all(launches.values()):
        raise AssertionError(f"(x) a kernel of the path never launched: {launches}")
    if metrics["recall@1000"] != REF_RECALL1000 or len(run) != ds.n_queries:
        raise AssertionError(f"(x) recall@1000 {metrics['recall@1000']} != 1.0 ({len(run)} runs)")
    if not 0.0 < metrics["ndcg@10"] <= 1.0:
        raise AssertionError(f"(x) NDCG@10 {metrics['ndcg@10']} outside (0, 1]")
    if metrics_10["ndcg@10"] != metrics["ndcg@10"]:
        raise AssertionError(f"(x) NDCG@10 at k=10 {metrics_10['ndcg@10']} != at k=1000")
    print(
        f"(x) run_dataset, {ds.n_queries} queries in batches of {TEXT_BATCH}: "
        f"NDCG@10 {metrics['ndcg@10']:.6f} (the reference's CPU backend {REF_NDCG10}), "
        f"recall@10 {metrics['recall@10']:.6f}, recall@100 {metrics['recall@100']:.6f}, "
        f"recall@1000 {metrics['recall@1000']} (the reference's {REF_RECALL1000}); "
        f"QPS at k=1000 {qps_1000:.1f} (one timed pass), at k={K} {qps_10:.1f} (best of 3); "
        f"S1 {launches['stream_dense_accumulate']} launches, S2 {launches['dense_topk']} [{label}]"
    )

    # Every S1 and S2 call of one k=1000 batch held to its plain version.
    restore_s1, s1_st = _checked(
        port_stream, "stream_dense_accumulate", stream_kernel.stream_dense_accumulate_plain,
        lambda a: a[6].numel(), _finite_err,
    )
    restore_s2, s2_st = _checked(
        port_stream, "dense_topk", topk.dense_topk_plain, lambda a: a[0].numel(),
        lambda o, w: _finite_err(o[0], w[0]),
    )
    try:
        engine.search(queries[:TEXT_BATCH], 1000)
    finally:
        restore_s1()
        restore_s2()
    if not s1_st["checked"] or not s2_st["checked"]:
        raise AssertionError(f"(x) S1 {s1_st['checked']}, S2 {s2_st['checked']} calls checked")
    print(
        f"(x) one {TEXT_BATCH}-query batch at k=1000: {s1_st['checked']} S1 and "
        f"{s2_st['checked']} S2 calls == plain (torch.equal); S2's largest on "
        f"{tuple(s2_st['args'][0].shape)}"
    )

    # The card against the same index on the CPU, and the float64 oracle.
    rng = np.random.default_rng(17)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), TEXT_SAMPLE, replace=False))]
    cpu = Bm25Index(seg, index.seed, IndexOptions(), device="cpu")
    want = hits_of(index.search_batch(sample, 1000))
    if want != hits_of(cpu.search_batch(sample, 1000)):
        raise AssertionError("(x) the card != the CPU-plain index at k=1000")
    t0 = time.perf_counter()
    mismatches = harness.oracle_rank_parity(ds, index, k=K, queries=queries)
    parity_s = time.perf_counter() - t0
    if mismatches:
        raise AssertionError(f"(x) {mismatches} oracle rank-parity mismatches at k={K}")
    print(
        f"(x) {TEXT_SAMPLE} sampled queries at k=1000: card == CPU-plain, ids and "
        f"scores ({sum(map(len, want))} hits); oracle_rank_parity over {len(queries)} "
        f"queries at k={K}: {mismatches} mismatches (the reference's CPU backend: 0), "
        f"{parity_s:.2f} host s"
    )

    # Persist through the native codecs, reopen on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "idx")
        t0 = time.perf_counter()
        save_index(index, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        opened = open_index(path, device="cuda")
        opened.engine()
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        size = dir_bytes(path)
        got = hits_of(opened.search_batch(sample, 1000))
        opened._wal.close()
    if got != want:
        raise AssertionError("(x) the reopened index != the live index")
    build_times["(x) save + open"] = save_s + open_s
    print(
        f"(x) save_index {save_s:.2f} s, open_index (and its engine) {open_s:.2f} s "
        f"on the native codecs, {size} B on disk; the reopened index == the live "
        f"index on {TEXT_SAMPLE} queries at k=1000 [{label}]"
    )
    return {name: {"(x)": n} for name, n in launches.items()}, ds, index


CLI_QUERIES = 64  # (y): (x)'s query texts searched through the command line
CLI_BLOCKMAX_SEARCHES = 8  # (y): of them, through the Block-Max index
REF_MEMORY_RATIO = 0.732  # BENCH_r05.json: the stream engine at 131,072 docs


def cli_slice(ds, x_index, parity_f, label, build_times):
    """Phase (y): the command line on the card, over (x)'s texts.  The
    texts as JSONL; ``cli.main`` builds them out of core and searches (x)'s
    query texts (stdout captured), each line equal to ``load_index`` in
    process on the card and on the CPU, the hits to (x)'s index by
    ``held_to_single``'s rule; S1 and S2 held to their plain versions on one
    search; a search as a subprocess on the card and on the CPU; insert,
    delete, maintain and inspect; a Block-Max build, its P1 and B1 held;
    the memory parity of both and of (f)'s engine; a search under
    ``profiling.trace``; the sharded dry run.  Returns the launches of S1,
    S2, P1, B1 and the shard kernels by kernel."""
    import glob
    import io
    import os
    import subprocess
    import tempfile

    import torch

    from vectorchord_bm25_tpu_torch import Query, cli, load_index
    from vectorchord_bm25_tpu_torch.ops import score_kernel, shard_kernels, stream_kernel, topk
    from vectorchord_bm25_tpu_torch.search import blockmax
    from vectorchord_bm25_tpu_torch.search import stream as port_stream
    from vectorchord_bm25_tpu_torch.text.tokenizer import tsvector
    from vectorchord_bm25_tpu_torch.tools.dryrun import dryrun_multichip
    from vectorchord_bm25_tpu_torch.utils import profiling
    from vectorchord_bm25_tpu_torch.utils.memparity import memory_parity_report

    root = os.path.dirname(os.path.abspath(__file__))
    secs = {}

    def run(step, *argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main([str(a) for a in argv])
        secs.setdefault(step, []).append(time.perf_counter() - t0)
        return out.getvalue()

    def query_of(index, text):
        return Query.from_tokens(index.seed, tsvector(text).keys())

    def lines_of(index, text):
        """``search``'s stdout, computed in process."""
        hits = index.search(query_of(index, text), k=K)
        return "".join(f"{r}\t{h.payload}\t{h.score:.6f}\n" for r, h in enumerate(hits, 1))

    def hits_in(index, texts):
        return [[(h.score, h.payload) for h in index.search(query_of(index, t), k=K)] for t in texts]

    texts = ds.query_texts[:CLI_QUERIES]
    n_workers = min(8, os.cpu_count() or 1)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.jsonl")
        t0 = time.perf_counter()
        with open(corpus, "w") as f:
            for lo in range(0, ds.n_docs, 8192):
                hi = min(ds.n_docs, lo + 8192)
                for i, text in zip(range(lo, hi), ds.source(lo, hi)):
                    f.write(json.dumps({"id": i, "text": text}) + "\n")
        secs["write JSONL"] = [time.perf_counter() - t0]
        stream_dir = os.path.join(tmp, "stream")
        out = run("build", "build", "--input", corpus, "--index", stream_dir,
                  "--workers", n_workers)
        if not out.startswith(f"built: {ds.n_docs} docs"):
            raise AssertionError(f"(y) build printed {out!r}")
        card = load_index(stream_dir, device="cuda")
        engine = card.engine()
        cpu = load_index(stream_dir, device="cpu")
        if card.engine_kind != "stream" or not engine.dev_words.is_cuda:
            raise AssertionError(f"(y) the CLI's index serves {card.engine_kind} on {card.device}")
        print(
            f"(y) cli build --workers {n_workers} (the default device, engine stream): "
            f"{out.strip()} in {secs['build'][0]:.2f} host s; JSONL of {ds.n_docs} texts "
            f"written in {secs['write JSONL'][0]:.2f} s [{label}]"
        )

        # The main path: (x)'s query texts through the command line.
        stream_kernel.LAUNCHES = topk.LAUNCHES = 0
        printed = [run("search", "search", "--index", stream_dir, "--query", t, "-k", K)
                   for t in texts]
        launches["stream_dense_accumulate"] = stream_kernel.LAUNCHES
        launches["dense_topk"] = topk.LAUNCHES
        if not all(launches.values()):
            raise AssertionError(f"(y) a kernel of the CLI's search never launched: {launches}")
        for text, out in zip(texts, printed, strict=True):
            if out != lines_of(card, text) or out != lines_of(cpu, text):
                raise AssertionError(f"(y) search {text!r}: the CLI != load_index on the card/CPU")
        rows = hits_in(card, texts)
        swaps = rule_swaps(rows, hits_in(x_index, texts), "(y) the CLI's index vs (x)'s")
        n_hits = sum(map(len, rows))
        search_s = secs["search"]
        print(
            f"(y) {len(texts)} cli searches at k={K}: every line == load_index in process on "
            f"the card and on the CPU (plain kernels); {n_hits} hits held to (x)'s index "
            f"(seeds differ: the same counts, {swaps} swaps of scores within 1e-4, scores "
            f"within rtol 2e-5); S1 {launches['stream_dense_accumulate']} launches, S2 "
            f"{launches['dense_topk']}; host s a search (index load included): median "
            f"{float(np.median(search_s)):.3f}, min {min(search_s):.3f}, max "
            f"{max(search_s):.3f} [{label}]"
        )
        restore_s1, s1_st = _checked(
            port_stream, "stream_dense_accumulate", stream_kernel.stream_dense_accumulate_plain,
            lambda a: a[6].numel(), _finite_err,
        )
        restore_s2, s2_st = _checked(
            port_stream, "dense_topk", topk.dense_topk_plain, lambda a: a[0].numel(),
            lambda o, w: _finite_err(o[0], w[0]),
        )
        try:
            held = run("held search", "search", "--index", stream_dir, "--query", texts[0],
                       "-k", K)
        finally:
            restore_s1()
            restore_s2()
        if held != printed[0] or not s1_st["checked"] or not s2_st["checked"]:
            raise AssertionError(f"(y) held search: S1 {s1_st['checked']}, S2 {s2_st['checked']}")
        print(
            f"(y) one cli search: {s1_st['checked']} S1 and {s2_st['checked']} S2 calls == "
            f"plain (torch.equal)"
        )

        # One search in a process of its own, on the card (the default) and
        # on the CPU.
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
        for device in (None, "cpu"):
            argv = [sys.executable, "-m", "vectorchord_bm25_tpu_torch.cli"]
            argv += [] if device is None else ["--device", device]
            argv += ["search", "--index", stream_dir, "--query", texts[1], "-k", str(K)]
            t0 = time.perf_counter()
            r = subprocess.run(argv, capture_output=True, text=True, cwd=root, env=env,
                               timeout=600)
            secs[f"subprocess search ({device or 'the card'})"] = [time.perf_counter() - t0]
            if r.returncode or r.stdout != printed[1]:
                raise AssertionError(
                    f"(y) python -m ...cli search on {device or 'the card'}: rc "
                    f"{r.returncode}, stdout {r.stdout!r}; stderr {r.stderr[-2000:]}"
                )
        print(
            f"(y) python -m vectorchord_bm25_tpu_torch.cli search, the default device and "
            f"--device cpu: both print the in-process lines; host s "
            f"{secs['subprocess search (the card)'][0]:.2f}, "
            f"{secs['subprocess search (cpu)'][0]:.2f} (interpreter start included)"
        )

        # insert, search, delete, maintain, inspect.
        new_payload = ds.n_docs
        out = run("insert", "insert", "--index", stream_dir, "--text", texts[2],
                  "--payload", new_payload)
        if out != f"inserted payload {new_payload}\n":
            raise AssertionError(f"(y) insert printed {out!r}")
        found = run("search", "search", "--index", stream_dir, "--query", texts[2], "-k", K)
        replayed = load_index(stream_dir, device="cuda")
        if f"\t{new_payload}\t" not in found or len(replayed.growing) != 1:
            raise AssertionError(f"(y) the inserted doc is not found: {found!r}")
        if found != lines_of(replayed, texts[2]) or found != lines_of(
            load_index(stream_dir, device="cpu"), texts[2]
        ):
            raise AssertionError("(y) after the insert the CLI != load_index (WAL replayed)")
        deleted = run("delete", "delete", "--index", stream_dir, "--payload", new_payload)
        if deleted != "deleted 1 documents\n":
            raise AssertionError(f"(y) delete printed {deleted!r}")
        out = run("maintain", "maintain", "--index", stream_dir)
        wal = os.path.getsize(os.path.join(stream_dir, "wal.log"))
        if out != (
            f"maintain done: merged 1 growing docs; sealed now {ds.n_docs} docs\n"
        ) or wal:
            raise AssertionError(f"(y) maintain printed {out!r}; wal.log {wal} B")
        info = json.loads(run("inspect", "inspect", "--index", stream_dir))
        after = load_index(stream_dir, device="cuda")
        seg = after.sealed
        want = {
            "n_docs": seg.n_docs, "n_live": after.n_docs, "n_tokens": seg.n_tokens,
            "n_blocks": seg.n_blocks, "sum_dl": seg.sum_dl, "growing_docs": len(after.growing),
            "deleted_sealed": int(after.deleted.sum()), "engine": after.engine_kind,
            "sealed_bytes": seg.memory_bytes(),
        }
        if {key: info[key] for key in want} != want or (
            info["n_docs"], info["growing_docs"]
        ) != (ds.n_docs, 0):
            raise AssertionError(f"(y) inspect {info} != the index's {want}")
        if run("search", "search", "--index", stream_dir, "--query", texts[0], "-k", K) != printed[0]:
            raise AssertionError("(y) after maintain a search != the first one")
        print(
            f"(y) cli insert (payload {new_payload}, found by search; load_index replays the "
            f"WAL on the card == the CPU), delete ({deleted.strip()!r}), maintain (wal.log "
            f"{wal} B), inspect == the index: n_docs {info['n_docs']}, growing_docs "
            f"{info['growing_docs']}, {info['n_tokens']} terms, {info['n_blocks']} blocks, "
            f"sealed_bytes {info['sealed_bytes']}; host s insert {secs['insert'][0]:.2f}, "
            f"delete {secs['delete'][0]:.2f}, maintain {secs['maintain'][0]:.2f}, inspect "
            f"{secs['inspect'][0]:.2f} [{label}]"
        )

        # The Block-Max engine, through the same file.
        bm_dir = os.path.join(tmp, "blockmax")
        out = run("build --engine blockmax", "build", "--input", corpus, "--index", bm_dir,
                  "--engine", "blockmax", "--workers", n_workers)
        if not out.startswith(f"built: {ds.n_docs} docs"):
            raise AssertionError(f"(y) build --engine blockmax printed {out!r}")
        bm = load_index(bm_dir, device="cuda")
        bm_engine = bm.engine()
        score_kernel.LAUNCHES = 0
        b1_zero()
        bm_printed = [
            run("blockmax search", "search", "--index", bm_dir, "--query", t, "-k", K)
            for t in texts[:CLI_BLOCKMAX_SEARCHES]
        ]
        launches["fused_range_scores"] = score_kernel.LAUNCHES
        launches.update(b1_read())
        if not all(launches.values()):
            raise AssertionError(f"(y) a kernel of the Block-Max search never launched: {launches}")
        for text, out in zip(texts, bm_printed):
            if out != lines_of(bm, text):
                raise AssertionError(f"(y) blockmax search {text!r}: the CLI != load_index")
        bm_swaps = rule_swaps(hits_in(bm, texts), rows, "(y) Block-Max vs the stream index")
        restore_p1, p1_st = _checked(
            blockmax, "fused_range_scores", score_kernel.fused_range_scores_plain,
            lambda a: a[2].numel(), _finite_err,
        )
        try:
            b1_check(bm_engine, [query_of(bm, t) for t in texts], label, "(y)")
        finally:
            restore_p1()
        if not p1_st["checked"]:
            raise AssertionError("(y) P1 saw no call of the held batch")
        print(
            f"(y) cli build --engine blockmax {secs['build --engine blockmax'][0]:.2f} host s; "
            f"{CLI_BLOCKMAX_SEARCHES} cli searches == load_index; {len(texts)} queries held to "
            f"the stream index ({bm_swaps} swaps within 1e-4); P1 "
            f"{launches['fused_range_scores']} launches, B1 "
            + ", ".join(f"{name} {launches[name]}" for name in B1_NAMES)
            + f"; one {len(texts)}-query batch: {p1_st['checked']} P1 calls == plain "
            f"(torch.equal), B1 as above [{label}]"
        )

        # Memory parity: device bytes over the reference's format bytes.
        for what, rep in (
            ("the CLI's stream index", memory_parity_report(engine, card.sealed)),
            ("the CLI's Block-Max index", memory_parity_report(bm_engine, bm.sealed)),
            (f"(f)'s stream engine (BENCH_r05.json: {REF_MEMORY_RATIO})", parity_f),
        ):
            print(f"(y) memory_parity_report of {what}: {json.dumps(rep)}")

        # One CLI search loop under torch.profiler.
        logdir = os.path.join(tmp, "trace")
        with profiling.trace(logdir, device="cuda"):
            for text in texts[:2]:
                with profiling.annotate("cli search"):
                    run("traced search", "search", "--index", stream_dir, "--query", text,
                        "-k", K)
        (trace_file,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(trace_file) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        named = {
            what: sorted(n for n in names if key in n)[:1]
            for what, key in (("S1", "dense_tiles_kernel"), ("S2", "dense_topk_select"),
                              ("annotation", "cli search"))
        }
        if not all(named.values()):
            raise AssertionError(f"(y) the trace names no {[w for w, n in named.items() if not n]}")
        print(
            f"(y) profiling.trace of 2 cli searches: {os.path.getsize(trace_file)} B of Chrome "
            f"trace naming S1 {named['S1'][0]!r}, S2 {named['S2'][0]!r} and the annotation "
            f"{named['annotation'][0]!r}"
        )

    # The sharded dry run on the card.
    shard_kernels.MERGE_LAUNCHES = shard_kernels.STATS_LAUNCHES = shard_kernels.SORT_LAUNCHES = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(SHARDS, device="cuda")
    secs["dry run"] = [time.perf_counter() - t0]
    launches.update(
        shard_merge=shard_kernels.MERGE_LAUNCHES, shard_stats=shard_kernels.STATS_LAUNCHES,
        posting_sort=shard_kernels.SORT_LAUNCHES,
    )
    if not out.getvalue().startswith("dryrun_multichip OK:") or not all(launches.values()):
        raise AssertionError(f"(y) dry run: {out.getvalue()!r}, launches {launches}")
    print(
        f"(y) {out.getvalue().strip()}; on the card: D1-sort {launches['posting_sort']}, "
        f"SH-stats {launches['shard_stats']}, SH-merge {launches['shard_merge']} launches; "
        f"{secs['dry run'][0]:.2f} host s"
    )
    build_times["(y) the command line, all of it"] = sum(sum(v) for v in secs.values())
    print(
        "(y) host s of each CLI step: "
        + "; ".join(
            f"{step} {sum(v):.2f}" + (f" in {len(v)} calls" if len(v) > 1 else "")
            for step, v in secs.items()
        )
        + f" [{label}]"
    )
    return {name: {"(y)": n} for name, n in launches.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=131072)
    parser.add_argument("--vocab", type=int, default=50000)
    parser.add_argument("--avg-len", type=int, default=80)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--sparse-docs", type=int, default=1 << 21,
        help="corpus size of phases (i)-(j); auto leaves the dense path at 2^21",
    )
    args = parser.parse_args()
    started = time.perf_counter()
    build_times = {}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        Document,
        IndexOptions,
        build_sealed_segment_from_postings,
    )
    from vectorchord_bm25_tpu_torch.data.synth import (
        synth_corpus_postings,
        synth_queries_fast,
    )
    from vectorchord_bm25_tpu_torch.ops import _build, score_kernel
    from vectorchord_bm25_tpu_torch.search import blockmax
    from vectorchord_bm25_tpu_torch.utils.device import card_label

    # (a) the card
    label = card_label()
    print(label)
    print(
        f"(a) card: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | "
        f"python {sys.version.split()[0]}"
    )

    # (b) build the kernel library
    t0 = time.perf_counter()
    lib = _build.library()
    print(
        f"(b) built {lib._name} with {_build.nvcc_path()} "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s"
    )
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"(b) ptxas: {line.split('info    :')[-1].strip()}")

    # The slice's index (host build), served on the card.
    t0 = time.perf_counter()
    keys, doc_ids, tfs, doc_start = synth_corpus_postings(
        args.docs, args.vocab, args.avg_len, seed=args.seed
    )
    seg = build_sealed_segment_from_postings(
        keys, doc_ids, tfs, args.docs, doc_grouped=True
    )
    queries = synth_queries_fast(
        keys, doc_start, seg, BATCH, seed=args.seed + 1
    )
    seed = args.seed.to_bytes(16, "little")
    index = Bm25Index(seg, seed, IndexOptions(), engine="blockmax", device="cuda")
    engine = index.engine()
    ri = engine.ranges
    build_times["(c)-(e) corpus, segment, queries, Block-Max index"] = (
        time.perf_counter() - t0
    )
    print(
        f"index: {seg.n_docs} docs, {seg.n_tokens} terms, "
        f"{ri.post_local.size - ri.range_size} postings, {ri.n_ranges} ranges "
        f"of {ri.range_size}, chunk {engine.chunk}; host build "
        f"{time.perf_counter() - t0:.1f} s; device index "
        f"{engine.memory_report()['total']} B"
    )

    # (c) kernel vs plain, on the windows the engine hands the kernel
    windows = []
    launch = blockmax.fused_range_scores

    def record(post_impact, post_local, starts, lens, *, rs):
        windows.append((starts.clone(), lens.clone(), rs))
        return launch(post_impact, post_local, starts, lens, rs=rs)

    blockmax.fused_range_scores = record
    try:
        engine.search(queries, K)
    finally:
        blockmax.fused_range_scores = launch
    imp, loc = engine.dev_post_impact, engine.dev_post_local
    max_err = 0.0
    for starts, lens, rs in windows:
        got = score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs)
        want = score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"kernel != plain on index windows {tuple(starts.shape)}: "
                f"max abs err {max_err}"
            )
    starts, lens, rs = windows[0]
    shape = (*starts.shape, rs)
    kernel_ms = device_ms(
        lambda: score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs)
    )
    kernel_paced_ms = cuda_ms(
        lambda: score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs)
    )
    plain_ms = cuda_ms(
        lambda: score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs)
    )
    active = int(lens.sum())
    p1_first_bound = p1_bound(imp, starts, lens, rs)
    print(
        f"(c) index windows: {len(windows)} rounds, kernel == plain "
        f"(torch.equal); Q,T,C,RS={shape}; {active} active lanes in round 1; "
        f"kernel {kernel_ms:.4f} ms on the card ({kernel_paced_ms:.4f} launched back "
        f"to back), plain {plain_ms:.4f} ms, bound {p1_first_bound['bound_ms']:.4f} ms "
        f"({p1_first_bound['bound_bytes']} B) [{label}]"
    )
    p1_last = p1_fields(imp, loc, windows[-1][0], windows[-1][1], rs)
    p1_last["round"] = len(windows)
    print(
        f"(c) P1 round {len(windows)} (the last): kernel {p1_last['ms']:.4f} ms on the "
        f"card ({p1_last['launch_paced_ms']:.4f} back to back), plain "
        f"{p1_last['plain_ms']:.4f} ms, bound {p1_last['bound_ms']:.4f} ms "
        f"({p1_last['bound_bytes']} B); {p1_last['active_lanes']} active lanes, "
        f"{p1_last['inactive_queries']:.4f} of {shape[0]} queries with no window [{label}]"
    )
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    p = imp.numel()
    r_loc = torch.randint(0, rs, (p,), device="cuda", generator=gen).to(torch.uint8)
    r_imp = torch.rand(p, device="cuda", generator=gen) * 8
    r_starts = torch.randint(
        0, p - rs, starts.shape, device="cuda", generator=gen, dtype=torch.int32
    )
    r_lens = torch.randint(
        0, rs + 1, starts.shape, device="cuda", generator=gen, dtype=torch.int32
    )
    got = score_kernel.fused_range_scores(r_imp, r_loc, r_starts, r_lens, rs=rs)
    want = score_kernel.fused_range_scores_plain(r_imp, r_loc, r_starts, r_lens, rs=rs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    rand_err = float((got - want).abs().max())
    print(
        f"(c) random windows with colliding slots: max abs err {rand_err:.3g} "
        f"(rtol 1e-5, atol 1e-6)"
    )
    # (c) the round outside P1: B1-bounds, B1-select, B1-merge, every round
    b1 = b1_check(engine, queries, label, "(c)")

    # (d) the slice: the facade serves 4096-query batches on the card
    index.search_batch(queries, K)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    score_kernel.LAUNCHES = 0
    b1_zero()
    qps = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        results = index.search_batch(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
    launches = score_kernel.LAUNCHES
    b1_by_phase = {"(d)": b1_read()}
    if launches == 0 or not all(b1_by_phase["(d)"].values()):
        raise AssertionError(
            f"the slice launched P1 {launches} times, B1 {b1_by_phase['(d)']}"
        )
    if len(results) != len(queries) or not all(
        np.isfinite(h.score) and h.score > 0 for hits in results for h in hits
    ):
        raise AssertionError("slice results are not finite positive hits")
    print(
        f"(d) slice: {ROUNDS} x search_batch({len(queries)} queries, k={K}); "
        f"{launches} P1 launches, B1 {b1_by_phase['(d)']}; {engine.last_rounds} pruning rounds in "
        f"the last batch; QPS per batch {[round(x, 1) for x in qps]} [{label}]"
    )
    prof_d = device_profile(
        lambda: index.search_batch(queries, K), "(d) profile", label,
        track=("round_merge", "round_select", "ImpactScorer"),
    )
    p1_profile = None if prof_d is None else {
        **prof_d["tracked"]["ImpactScorer"], "busy_ms": prof_d["busy_ms"],
        "wall_ms": prof_d["wall_ms"],
    }

    # (e) correctness at that size
    rng = np.random.default_rng(args.seed + 2)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    cpu = Bm25Index(seg, seed, IndexOptions(), engine="blockmax", device="cpu")
    recall, total, ties, n_del = audit(index, cpu, seg, sample)
    print(
        f"(e) {AUDIT} sampled queries: GPU == CPU-plain; recall@{K} vs the "
        f"float64 oracle {recall} ({total} hits, {ties} boundary ties excused)"
    )
    n_rounds = rounds_equal(index.engine(), cpu.engine(), sample, "(e)")
    print(
        f"(e) after deleting {n_del} docs (1%) and with a prefilter: "
        f"GPU == CPU-plain on {AUDIT} queries; last_rounds {n_rounds} on the "
        f"card and on the CPU"
    )

    stream, parity_f = stream_slice(
        args, seg, seed, queries, keys, tfs, doc_start, label, build_times
    )
    t0 = time.perf_counter()
    rest, sweep, b1_rest = blockmax_rest(
        args, seg, seed, queries, ri, engine, cpu.engine(), label
    )
    build_times["(l)-(n) phases, all of them"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact_entries, p1_hybrid, s2_exact, b1_hybrid = exact_hybrid(
        args, seg, seed, queries, ri, engine, label
    )
    build_times["(o)-(q) phases, all of them"] = time.perf_counter() - t0
    b1_by_phase.update(b1_rest)
    b1_by_phase.update(b1_hybrid)
    # (t) phase (d)'s index, with phase (e)'s deletes, restarted
    t0 = time.perf_counter()
    picks = np.random.default_rng(args.seed + 9).choice(seg.n_docs, 1024, replace=False)
    new_docs = [
        Document(
            keys=keys[int(doc_start[d]) : int(doc_start[d + 1])],
            values=tfs[int(doc_start[d]) : int(doc_start[d + 1])],
        )
        for d in picks
    ]
    restart(index, queries, new_docs, label, "Block-Max")
    build_times["(t) Block-Max"] = time.perf_counter() - t0
    del new_docs
    # (u) the sharded index on phase (d)'s postings
    shard_launches, s2_flat, merge_u = sharded_slice(
        args, seg, queries, keys, doc_ids, tfs, doc_start, label, build_times
    )
    # P1 and S2 entries count every main-path run that launched them.
    s2_entry = next(e for e in stream if e["name"] == "dense_topk")
    s2_entry["launches_by_phase"] = {
        "(f)": s2_entry["launches"], "(n)": sweep["dense_topk"]["sweep_launches"],
        **s2_exact,
    }
    s2_entry["launches"] = sum(s2_entry["launches_by_phase"].values())
    s2_entry.update(sweep["dense_topk"])
    s2_entry["flat_u"] = s2_flat
    p1_bound_fields = p1_bound(imp, starts, lens, rs)
    p1_sweep = sweep["fused_range_scores"]
    slice_line = (
        f"slice QPS {float(np.median(qps)):.1f} (median of {ROUNDS} batches of "
        f"{len(queries)}, k={K}, {seg.n_docs} docs; min {min(qps):.1f}, max "
        f"{max(qps):.1f}) [{label}]"
    )
    # The 131,072-doc corpus and its indexes go before phase (i)'s corpus.
    del index, engine, cpu, seg, queries, keys, doc_ids, tfs, doc_start, sample, ri
    sparse, b1_large, (shard_entries, large_launches) = sparse_slice(args, label, build_times)
    for name, by in large_launches.items():
        shard_launches.setdefault(name, {}).update(by)
    # (x) from raw text to ranked, evaluated results
    x_launches, ds, x_index = text_slice(label, build_times)
    for name, by in x_launches.items():
        shard_launches.setdefault(name, {}).update(by)
    # (y) the command line on the card
    for name, by in cli_slice(ds, x_index, parity_f, label, build_times).items():
        shard_launches.setdefault(name, {}).update(by)
    del ds, x_index
    next(e for e in shard_entries if e["name"] == "shard_merge")["bodies_u"] = merge_u
    b1_by_phase["(s)"] = b1_large["launches"]
    p1_hybrid["(s)"] = b1_large["p1_launches"]
    b1_entries = [
        {
            "name": name,
            "route": "cuda",
            "source": "vectorchord_bm25_tpu_torch/csrc/blockmax_round.cu",
            "replaces": f"vectorchord_bm25_tpu/search/blockmax.py:{line}",
            "launches": sum(by[name] for by in b1_by_phase.values()),
            "launches_by_phase": {ph: by[name] for ph, by in b1_by_phase.items()},
            **b1[name],
            "r16384": b1_large["measured"][name],
            "rounds_a_batch_r16384": b1_large["rounds"],
        }
        for name, line in zip(B1_NAMES, B1_REPLACES)
    ]
    b1_entries[B1_NAMES.index("round_select")]["r8192"] = b1_large["measured"][
        "round_select_r8192"
    ]
    # The sharded phases' launches, added to each kernel's by phase.
    kernels = [
        {
            "name": "fused_range_scores",
            "route": "cuda",
            "source": "vectorchord_bm25_tpu_torch/csrc/score_kernel.cu",
            "replaces": "vectorchord_bm25_tpu/ops/score_kernel.py:67",
            "launches_by_phase": {
                "(d)": launches, "(n)": p1_sweep["sweep_launches"], **p1_hybrid,
            },
            "max_abs_err": max_err,
            "max_abs_err_random": rand_err,
            "ms": kernel_ms,
            "launch_paced_ms": kernel_paced_ms,
            "plain_ms": plain_ms,
            **p1_bound_fields,
            "library_ms": None,
            "last_round": p1_last,
            "profile_d": p1_profile,
            **p1_sweep,
        },
        *rest,
        *b1_entries,
        *stream,
        *sparse,
        *exact_entries,
        *shard_entries,
    ]
    for entry in kernels:
        if "launches_by_phase" not in entry:
            entry["launches_by_phase"] = {FIRST_PHASE[entry["name"]]: entry["launches"]}
        by = entry["launches_by_phase"]
        by.update(shard_launches.pop(entry["name"], {}))
        entry["launches"] = sum(by.values())
    if shard_launches:
        raise AssertionError(f"launches of no kernels-line entry: {sorted(shard_launches)}")
    # (k) where the host time went
    print(
        "(k) host build: "
        + "; ".join(f"{name} {sec:.1f} s" for name, sec in build_times.items())
        + f"; script {time.perf_counter() - started:.1f} s so far"
    )
    print(json.dumps({"kernels": kernels}))
    print(slice_line)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
