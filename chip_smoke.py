#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU: the Block-Max engine and
the served default, the stream engine, with a growing segment and at the
scale where its ``auto`` strategy leaves the dense path.

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
      times from CUDA events;
  (d) the slice: ``Bm25Index(..., engine="blockmax", device="cuda")``
      over a 131,072-doc synthetic corpus (bench.py's default,
      trec-covid scale) serving ``search_batch(k=10)`` in 4,096-query
      batches; the kernel's launch count must grow;
  (e) correctness at that size: 256 sampled queries equal the same
      engine on the CPU (plain kernel), also after deleting 1% of the
      payloads and under a prefilter; recall@10 = 1.0 against the
      float64 oracle, excusing f32 boundary ties as bench.py does;
  (f) the served default: ``Bm25Index(seg, seed, IndexOptions(),
      device="cuda")`` (engine "stream", dense below 2^21 docs) on the same
      corpus.  On every dispatch the engine hands its kernels, S1
      (``stream_dense_accumulate``) and S2 (``dense_topk``) must equal
      their plain versions (``torch.equal``); both and their plain
      versions are timed with CUDA events on the first dispatch.  Then 5
      batches of 4,096 queries at k=10, QPS each; both launch counts must
      grow;
  (g) 256 sampled queries equal the same facade on the CPU (plain
      versions), also after deleting 1% and under a prefilter; recall@10
      = 1.0 against the float64 oracle; ``memory_report()["total"]``
      equals the bytes of the stream's host arrays;
  (h) 1,024 inserted docs (the term counts of corpus docs, so every term
      is known) served by ``search_batch`` through the growing segment's
      stream engine on the card: equal to the CPU, and its S1 launches
      grow;
  (i) the served default at scale: a 2,097,152-doc corpus (``--sparse-docs``;
      the same generator and shape, only the doc count raised, the
      smallest size at which ``auto`` leaves the dense path), served by
      ``Bm25Index(seg, seed, IndexOptions(), device="cuda")``.  One
      512-query batch of informative queries (``synth_queries_fast``) and
      one of heavy ones (``synth_queries_from_segment(mix="heavy")``), k=10:
      on every dispatch the engine hands them, S3 (``stream_sparse_decode``),
      S4 (``sparse_combine``) and S5 (``stream_rescore``) must equal their
      plain versions (``torch.equal``); each and its plain version timed
      with CUDA events on its largest dispatch.  Then 5 batches of each mix,
      QPS each and ``last_ms_stats``; the three launch counts must grow from
      0 and the heavy mix must route queries to MaxScore;
  (j) 64 sampled queries (32 of each mix): the card equals the CPU-plain
      engine under ``auto``, ``sparse`` and ``maxscore``, also after
      deleting 1% and under a prefilter; recall@10 = 1.0 against the
      float64 oracle on 32 of them; ``memory_report()["total"]`` equals
      the bytes of the stream's host arrays;
  (k) the host build time of each phase.

The ``kernels`` line lists P1 and S1-S5; the last line of stdout is
``{"ok": true, "device": {...}}``.
Needs torch with CUDA and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
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


def stream_slice(args, seg, seed, queries, keys, tfs, doc_start, label, build_times):
    """Phases (f)-(h): the served default engine with a growing segment.
    Returns the kernels-line entries of S1 and S2."""
    import torch

    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        Document,
        IndexOptions,
    )
    from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk
    from vectorchord_bm25_tpu_torch.search import stream as port_stream

    # (f) the served default on the card
    t0 = time.perf_counter()
    index = Bm25Index(seg, seed, IndexOptions(), device="cuda")
    engine = index.engine()
    si = engine.stream
    if index.engine_kind != "stream" or type(engine) is not port_stream.StreamEngine:
        raise AssertionError(f"default engine is {index.engine_kind}: {engine!r}")
    build_times["(f) stream index"] = time.perf_counter() - t0
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
        got = stream_kernel.stream_dense_accumulate(*a)
        want = stream_kernel.stream_dense_accumulate_plain(*a)
        torch.cuda.synchronize()
        s1_err = max(s1_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
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
            f"{len(np.unique(a[8]))} ordinals, {int((got > 0).sum())} nonzero "
            f"accumulator cells]: S1 == plain, S2 == plain (torch.equal)"
        )
        del got
    a = dispatches[0]
    n_q, n_docs = a[-2], a[-1]
    s1_ms = cuda_ms(lambda: stream_kernel.stream_dense_accumulate(*a), iters=10)
    s1_plain_ms = cuda_ms(lambda: stream_kernel.stream_dense_accumulate_plain(*a), iters=5)
    zero_ms = cuda_ms(lambda: topk.new_accumulator(n_q, n_docs, "cuda"), iters=10)
    acc = stream_kernel.stream_dense_accumulate(*a)
    s2_ms = cuda_ms(lambda: topk.dense_topk(acc, kk, n_docs), iters=10)
    s2_plain_ms = cuda_ms(lambda: topk.dense_topk_plain(acc, kk, n_docs), iters=5)
    del acc
    print(
        f"(f) {len(dispatches)} dispatches; first: n_q={n_q}, N+1={n_docs + 1}, "
        f"{a[6].numel()} windows; S1 {s1_ms:.4f} ms vs plain {s1_plain_ms:.4f} ms "
        f"(both include the {zero_ms:.4f} ms accumulator zero-fill); S2 "
        f"{s2_ms:.4f} ms vs plain {s2_plain_ms:.4f} ms at k={kk} [{label}]"
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
    stream_kernel.LAUNCHES = 0
    index.growing.topk_batch_async(sample, K)()
    grow_launches = stream_kernel.LAUNCHES
    g_engine = index.growing.device_engine()
    if not grow_launches or not g_engine.dev_words.is_cuda:
        raise AssertionError("the growing segment was not served by S1 on the card")
    got = hits_of(index.search_batch(sample, K))
    if got != hits_of(cpu.search_batch(sample, K)):
        raise AssertionError("growing: GPU != CPU-plain")
    n_new = sum(p >= base for hits in got for _, p in hits)
    print(
        f"(h) {len(index.growing)} growing docs ({g_engine.n_docs} in the card "
        f"engine, {g_engine.stream.n_windows} windows): GPU == CPU-plain on "
        f"{AUDIT} queries, {n_new} growing hits; growing engine S1 launches "
        f"{grow_launches}"
    )
    return [
        {
            "name": "stream_dense_accumulate",
            "route": "cuda",
            "source": "vectorchord_bm25_tpu_torch/csrc/stream_dense.cu",
            "replaces": "vectorchord_bm25_tpu/search/stream.py:171",
            "launches": s1_launches,
            "max_abs_err": s1_err,
            "ms": s1_ms,
            "plain_ms": s1_plain_ms,
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
        },
    ]


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
             "err": 0.0, "args": None, "size": -1}

    def wrapper(*args):
        out = real(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name} != its plain version on a dispatch")
        stats["err"] = max(stats["err"], errs(out, want))
        stats["checked"] += 1
        if size(args) > stats["size"]:
            stats["args"], stats["size"] = args, size(args)
        return out

    setattr(module, name, wrapper)
    return (lambda: setattr(module, name, real)), stats


def _finite_err(a, b):
    import torch

    live = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(live, a - b, 0.0).abs().max()) if a.numel() else 0.0


def sparse_slice(args, label, build_times):
    """Phases (i)-(j): the served default at scale, where ``auto`` leaves the
    dense path.  Returns the kernels-line entries of S3, S4 and S5."""
    import torch

    from bench import (
        synth_corpus_postings,
        synth_queries_fast,
        synth_queries_from_segment,
    )
    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        IndexOptions,
        build_sealed_segment_from_postings,
    )
    from vectorchord_bm25_tpu_torch.ops import stream_rescore, stream_sparse, topk
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
    del keys, doc_ids, tfs, doc_start
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

    # Every dispatch the engine hands S3, S4 and S5 against the plain versions.
    checks = [
        _checked(
            stream_sparse, "stream_sparse_decode",
            stream_sparse.stream_sparse_decode_plain, lambda a: a[6].numel() * 128,
            lambda out, want: _finite_err(out[1], want[1]),
        ),
        _checked(
            stream_sparse, "sparse_combine", stream_sparse.sparse_combine_plain,
            lambda a: a[0].numel(),
            lambda out, want: _finite_err(topk._unpack(out)[0], topk._unpack(want)[0]),
        ),
        _checked(
            stream_rescore, "stream_rescore", stream_rescore.stream_rescore_plain,
            lambda a: a[6].numel() * a[7].shape[1], _finite_err,
        ),
    ]
    try:
        for mix, queries in batches.items():
            index.search_batch(queries, K)
            st = engine.last_ms_stats
            print(
                f"(i) {mix}: {len(queries)} queries, routed to MaxScore "
                f"{st and st['routed_queries']}; dispatches checked so far: "
                + ", ".join(f"{c['name']} {c['checked']}" for _, c in checks)
                + " (torch.equal)"
            )
    finally:
        for restore, _ in checks:
            restore()
    stats = [c for _, c in checks]
    if not all(c["checked"] for c in stats):
        raise AssertionError(f"a kernel saw no dispatch: {[c['checked'] for c in stats]}")
    for c in stats:
        a = c["args"]
        c["ms"] = cuda_ms(lambda: c["real"](*a), iters=5, warmup=1)
        c["plain_ms"] = cuda_ms(lambda: c["plain"](*a), iters=2, warmup=1)
        print(
            f"(i) {c['name']}: {c['checked']} dispatches equal to the plain "
            f"version; largest ({c['size']} lanes) {c['ms']:.4f} ms vs plain "
            f"{c['plain_ms']:.4f} ms [{label}]"
        )
        c["args"] = None

    # The main path at scale: every count from 0, 5 batches of each mix.
    stream_sparse.DECODE_LAUNCHES = stream_sparse.COMBINE_LAUNCHES = 0
    stream_rescore.LAUNCHES = 0
    heavy_stats = None
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
        "stream_sparse_decode": stream_sparse.DECODE_LAUNCHES,
        "sparse_combine": stream_sparse.COMBINE_LAUNCHES,
        "stream_rescore": stream_rescore.LAUNCHES,
    }
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if not heavy_stats or heavy_stats["routed_queries"] <= 0:
        raise AssertionError(f"auto routed no heavy query to MaxScore: {heavy_stats}")
    print(f"(i) launches over the timed batches: {launches}")

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
            got = gpu.search(sample, K, **kw)
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
                f"{st and st['routed_queries']}, fallback {st and st['fallback_queries']})"
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
    replaces = {
        "stream_sparse_decode": ("stream_sparse.cu", ":327"),
        "sparse_combine": ("stream_sparse.cu", ":337"),
        "stream_rescore": ("stream_rescore.cu", ":366"),
    }
    return [
        {
            "name": c["name"],
            "route": "cuda",
            "source": f"vectorchord_bm25_tpu_torch/csrc/{replaces[c['name']][0]}",
            "replaces": f"vectorchord_bm25_tpu/search/stream.py{replaces[c['name']][1]}",
            "launches": launches[c["name"]],
            "max_abs_err": c["err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
        }
        for c in stats
    ]


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

    from bench import synth_corpus_postings, synth_queries_fast
    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        IndexOptions,
        build_sealed_segment_from_postings,
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
    kernel_ms = cuda_ms(
        lambda: score_kernel.fused_range_scores(imp, loc, starts, lens, rs=rs)
    )
    plain_ms = cuda_ms(
        lambda: score_kernel.fused_range_scores_plain(imp, loc, starts, lens, rs=rs)
    )
    active = int(lens.sum())
    print(
        f"(c) index windows: {len(windows)} rounds, kernel == plain "
        f"(torch.equal); Q,T,C,RS={shape}; {active} active lanes in round 1; "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"[{label}]"
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

    # (d) the slice: the facade serves 4096-query batches on the card
    index.search_batch(queries, K)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    score_kernel.LAUNCHES = 0
    qps = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        results = index.search_batch(queries, K)
        qps.append(len(queries) / (time.perf_counter() - t0))
    launches = score_kernel.LAUNCHES
    if launches == 0:
        raise AssertionError("the slice never launched the CUDA kernel")
    if len(results) != len(queries) or not all(
        np.isfinite(h.score) and h.score > 0 for hits in results for h in hits
    ):
        raise AssertionError("slice results are not finite positive hits")
    print(
        f"(d) slice: {ROUNDS} x search_batch({len(queries)} queries, k={K}); "
        f"{launches} kernel launches; {engine.last_rounds} pruning rounds in "
        f"the last batch; QPS per batch {[round(x, 1) for x in qps]} [{label}]"
    )

    # (e) correctness at that size
    rng = np.random.default_rng(args.seed + 2)
    sample = [queries[i] for i in np.sort(rng.choice(len(queries), AUDIT, replace=False))]
    cpu = Bm25Index(seg, seed, IndexOptions(), engine="blockmax", device="cpu")
    recall, total, ties, n_del = audit(index, cpu, seg, sample)
    print(
        f"(e) {AUDIT} sampled queries: GPU == CPU-plain; recall@{K} vs the "
        f"float64 oracle {recall} ({total} hits, {ties} boundary ties excused)"
    )
    print(
        f"(e) after deleting {n_del} docs (1%) and with a prefilter: "
        f"GPU == CPU-plain on {AUDIT} queries"
    )

    stream = stream_slice(
        args, seg, seed, queries, keys, tfs, doc_start, label, build_times
    )
    slice_line = (
        f"slice QPS {float(np.median(qps)):.1f} (median of {ROUNDS} batches of "
        f"{len(queries)}, k={K}, {seg.n_docs} docs; min {min(qps):.1f}, max "
        f"{max(qps):.1f}) [{label}]"
    )
    # The 131,072-doc corpus and its indexes go before phase (i)'s corpus.
    del index, engine, cpu, seg, queries, keys, tfs, doc_start, sample
    sparse = sparse_slice(args, label, build_times)
    # (k) where the host time went
    print(
        "(k) host build: "
        + "; ".join(f"{name} {sec:.1f} s" for name, sec in build_times.items())
        + f"; script {time.perf_counter() - started:.1f} s so far"
    )
    print(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": "fused_range_scores",
                        "route": "cuda",
                        "source": "vectorchord_bm25_tpu_torch/csrc/score_kernel.cu",
                        "replaces": "vectorchord_bm25_tpu/ops/score_kernel.py:67",
                        "launches": launches,
                        "max_abs_err": max_err,
                        "max_abs_err_random": rand_err,
                        "ms": kernel_ms,
                        "plain_ms": plain_ms,
                    },
                    *stream,
                    *sparse,
                ]
            }
        )
    )
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
