#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Block-Max slice once on one GPU.

    python3 chip_smoke.py [--docs N] [--seed S]

Phases (each prints its lines; any failure raises, so the exit code is
not 0 and no result line is printed):

  (a) the card's ``name, power.limit``, torch and CUDA versions;
  (b) build the CUDA kernel library from ``vectorchord_bm25_tpu_torch/csrc``
      with nvcc for sm_90a;
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
      float64 oracle, excusing f32 boundary ties as bench.py does.

The last line of stdout is ``{"ok": true, "device": {...}}``.
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


def recall_vs_oracle(seg, queries, results, k, oracle_scores, oracle_topk):
    """recall@k of payload results vs the float64 oracle (bench.py's
    audit: a missing doc whose f64 score is within 2 f32 ulps of the kth
    score is an f32-resolution boundary tie, not a miss)."""
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=131072)
    parser.add_argument("--vocab", type=int, default=50000)
    parser.add_argument("--avg-len", type=int, default=80)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from bench import synth_corpus_postings, synth_queries_fast
    from vectorchord_bm25_tpu_torch import (
        Bm25Index,
        IndexOptions,
        SessionConfig,
        build_sealed_segment_from_postings,
        oracle_scores,
        oracle_topk,
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
    gpu_hits = index.search_batch(sample, K)
    if hits_of(gpu_hits) != hits_of(cpu.search_batch(sample, K)):
        raise AssertionError("GPU results differ from the CPU-plain run")
    recall, total, ties = recall_vs_oracle(
        seg, sample, hits_of(gpu_hits), K, oracle_scores, oracle_topk
    )
    if recall != 1.0:
        raise AssertionError(f"recall@{K} vs oracle {recall} != 1.0")
    print(
        f"(e) {AUDIT} sampled queries: GPU == CPU-plain; recall@{K} vs the "
        f"float64 oracle {recall} ({total} hits, {ties} boundary ties excused)"
    )

    def doomed(p):
        return (np.asarray(p) * 2654435761) % 100 == 0

    n_del = index.bulkdelete(doomed)
    if cpu.bulkdelete(doomed) != n_del or not n_del:
        raise AssertionError("bulkdelete counts differ or deleted nothing")
    sess = SessionConfig(prefilter=True)

    def keep(p):
        return np.asarray(p) % 3 != 0

    for kw in ({}, {"filter_fn": keep, "session": sess}):
        got = hits_of(index.search_batch(sample, K, **kw))
        if got != hits_of(cpu.search_batch(sample, K, **kw)):
            raise AssertionError(f"GPU != CPU-plain after deletes {kw and '+ prefilter'}")
        bad = [p for hits in got for _, p in hits if doomed(p) or (kw and not keep(p))]
        if bad:
            raise AssertionError(f"deleted or filtered payloads returned: {bad[:5]}")
    print(
        f"(e) after deleting {n_del} docs (1%) and with a prefilter: "
        f"GPU == CPU-plain on {AUDIT} queries"
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
                    }
                ]
            }
        )
    )
    print(
        f"slice QPS {float(np.median(qps)):.1f} (median of {ROUNDS} batches of "
        f"{len(queries)}, k={K}, {seg.n_docs} docs; min {min(qps):.1f}, max "
        f"{max(qps):.1f}) [{label}]"
    )
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
