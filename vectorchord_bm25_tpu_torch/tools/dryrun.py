"""One full sharded step on the port's stacked shards (counterpart of
``__graft_entry__.py::dryrun_multichip``).

The reference builds an n-device jax mesh; here the n shards are stacked
along a leading tensor dimension on one ``device`` (``parallel/shard.py``),
so there is no mesh and no XLA flag.  The checks are the reference's:

- the device build (D1-sort, SH-stats on ``device``) equals the host build
  (``block_docids``, ``token_keys``);
- ``global_stats_step`` gives N and sum dl;
- the exact engine's search, then ``blockmax``, ``stream`` and
  ``maxscore`` ranking like it (scores within rtol 1e-5, ranks equal up to
  ties), each merged across shards by SH-merge;
- on an engineered corpus one shard cannot certify its MaxScore pool: the
  (shard, query) pair rides the partial rescan
  (``fallback_windows_skipped`` > 0) and the ids equal the exhaustive
  engine's;
- insert, delete and maintain on the default (stream) engine, with
  searches between them.

    python -m vectorchord_bm25_tpu_torch.tools.dryrun
"""

from __future__ import annotations

import numpy as np

__all__ = ["dryrun_multichip"]


def _tiny_corpus(n_docs: int = 64, vocab: int = 40, seed: int = 7):
    from ..text.intern import Document, Query

    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n_terms = int(rng.integers(2, 12))
        ids = rng.integers(0, vocab, size=n_terms)
        docs.append(Document.from_int_ids(ids.tolist()))
    queries = [
        Query.from_int_ids(rng.integers(0, vocab, size=3).tolist())
        for _ in range(4)
    ]
    return docs, queries


def _check(ok, what: str) -> None:
    # Not an assert: the checks hold under ``python -O`` too.
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_shards: int = 8, device="cuda") -> None:
    """One full sharded step over ``n_shards`` shards on ``device`` (tiny
    shapes); prints the reference's OK line, raises on any failed check."""
    from ..parallel.shard import ShardedIndex
    from ..text.intern import Document, Query
    from ..utils.device import as_device

    device = as_device(device)
    docs, queries = _tiny_corpus(n_docs=8 * n_shards)

    # The device build (D1-sort + the doc-offset scan on the card) must be
    # bit-identical to the host per-shard build.  Both serve the default
    # (stream) engine.
    index = ShardedIndex.build(docs, n_shards, device=device, device_build=False)
    dev_built = ShardedIndex.build(docs, n_shards, device=device, device_build=True)
    for vh, vd in zip(index.views, dev_built.views):
        _check(
            np.array_equal(vh.segment.block_docids, vd.segment.block_docids)
            and np.array_equal(vh.segment.token_keys, vd.segment.token_keys),
            "the device build differs from the host build",
        )

    # Build step: global stats over the stacked shards (SH-stats).
    n, sdl, avgdl = index.global_stats_step()
    _check(n == len(docs) and sdl > 0, f"global stats N={n}, sum_dl={sdl}")

    # Forward step: doc-sharded batched search, SH-merge of the shards'
    # top-k.
    st_scores, st_gids, _ = index.search(queries, k=5)
    _check(
        st_scores.shape == (len(queries), 5)
        and np.all((st_gids >= -1) & (st_gids < index.n_docs)),
        f"search returned {st_scores.shape}, ids {st_gids.tolist()}",
    )
    found = int((st_gids >= 0).sum())

    # The exact engine's ranks are what the others are held to.
    exact = ShardedIndex.build(docs, n_shards, device=device, engine="exact")
    scores, gids, _ = exact.search(queries, k=5)

    # The pruned engine under sharding must reproduce the exact engine's
    # RANKS and SCORES (scores may differ by f32 accumulation-order ulps,
    # ranks must agree up to exact score ties).
    pruned = ShardedIndex.build(docs, n_shards, device=device, engine="blockmax")
    p_scores, p_gids, _ = pruned.search(queries, k=5)
    _check(np.array_equal(p_gids >= 0, gids >= 0), "blockmax hit counts")
    for qi in range(len(queries)):
        got = p_gids[qi][p_gids[qi] >= 0]
        expect = gids[qi][gids[qi] >= 0]
        np.testing.assert_allclose(
            p_scores[qi][: got.size], scores[qi][: expect.size], rtol=1e-5
        )
        for j in range(got.size):
            if got[j] != expect[j]:
                _check(
                    abs(p_scores[qi][j] - scores[qi][j])
                    <= 1e-5 * abs(scores[qi][j]),
                    f"rank mismatch beyond float ties at q{qi}[{j}]",
                )

    # The equal-index-memory stream engine must reproduce the exact
    # engine's hits.
    _check(np.array_equal(st_gids >= 0, gids >= 0), "stream hit counts")
    for qi in range(len(queries)):
        got = st_gids[qi][st_gids[qi] >= 0]
        expect = gids[qi][gids[qi] >= 0]
        np.testing.assert_allclose(
            st_scores[qi][: got.size], scores[qi][: expect.size], rtol=1e-5
        )

    # Per-shard MaxScore with tiered certification must rank exactly like
    # the exhaustive sharded stream.
    ms = ShardedIndex.build(
        docs, n_shards, device=device, engine="stream", strategy="maxscore"
    )
    ms_scores, ms_gids, _ = ms.search(queries, k=5)
    _check(np.array_equal(ms_gids, st_gids), "maxscore ids != stream ids")

    # Per-shard certification fallback: term A is rare (df=3, all its docs
    # in shard 0) and term B ubiquitous (tiny idf), so in shard 0 the
    # [A, B] query's tier prefixes hold only A's 3 windows (< k finite
    # partials: 'hopeless') while every other shard certifies trivially.
    # The (shard 0, query) pair must ride the partial rescan and still
    # merge to the exhaustive engine's exact ranks.
    rng = np.random.default_rng(11)
    n2 = 16 * n_shards
    term_a, term_b = 1000, 1001
    docs2 = []
    for i in range(n2):
        ids = [term_b] + rng.integers(2000, 2050, size=4).tolist()
        if i < 3:
            ids.append(term_a)
        docs2.append(Document.from_int_ids(ids))
    q2 = [
        Query.from_int_ids([term_a, term_b]),
        Query.from_int_ids([term_b]),
        Query.from_int_ids([term_a]),
    ]
    ms2 = ShardedIndex.build(
        docs2, n_shards, device=device, engine="stream", strategy="maxscore"
    )
    ex2 = ShardedIndex.build(docs2, n_shards, device=device, engine="stream")
    s_ms2, g_ms2, _ = ms2.search(q2, k=5)
    s_ex2, g_ex2, _ = ex2.search(q2, k=5)
    st = ms2.last_ms_stats
    _check(st is not None and st["fallback_queries"] >= 1, f"no fallback: {st}")
    fb_pairs = st["tiers"][-1]["pairs"] - st["tiers"][-1]["pairs_certified"]
    _check(
        fb_pairs >= 1 and st["fallback_windows_skipped"] > 0,
        f"the partial rescan was not taken: {st}",
    )
    _check(np.array_equal(g_ms2, g_ex2), f"fallback ids {g_ms2} != {g_ex2}")
    np.testing.assert_allclose(s_ms2, s_ex2, rtol=1e-5)

    # The mutation surface: insert -> delete -> maintain, with searches
    # after each.
    index.insert(Document.from_int_ids([1, 2, 3]), payload=9999)
    s2, g2, p2 = index.search(queries, k=5)
    _check(np.all(p2 < 10000), f"payloads {p2.tolist()}")
    n_del = index.bulkdelete_payloads([0, 1, 2])
    _check(n_del == 3, f"deleted {n_del} of 3")
    index.maintain()
    _check(index.n_live == len(docs) + 1 - 3, f"{index.n_live} live docs")
    s3, g3, p3 = index.search(queries, k=5)
    _check(s3.shape == (len(queries), 5), f"search returned {s3.shape}")

    print(
        f"dryrun_multichip OK: {n_shards} devices, N={n}, sum_dl={sdl}, "
        f"{found} hits over {len(queries)} queries (exact+blockmax+stream"
        f"+maxscore rank parity; device build bit-identical; "
        f"insert/delete/maintain ok; per-shard cert fallback exercised: "
        f"{fb_pairs} uncertified (shard,query) pair(s), "
        f"{st['fallback_windows_skipped']} windows skipped by skip_pairs, "
        f"{st['fallback_windows_scanned']} rescanned, ranks exact)"
    )


if __name__ == "__main__":
    dryrun_multichip()
