"""The sharded index's device code in the port (``ops/shard_kernels.py``),
plain versions on the CPU, against the reference's jax code on the same
numpy-made inputs.

- SH-merge (``shard_merge``) against the reference's rebase and
  ``all_gather`` merge: ``g_ids`` (id + offset where the score is finite,
  ``INT_MAX`` elsewhere), then ``lax.sort((-s, id), num_keys=2)`` over each
  query's ``D * kk`` candidates (``parallel/shard.py:820-832``), on runs in
  merge order as the bodies hand them over, with ties across shards,
  ``-inf`` pads, widths below ``kk`` and 0, and D in {1, 2, 8}; a run out
  of merge order raises.
- D1-sort (``posting_sort``) against ``lax.sort(..., num_keys=5)``
  (``parallel/devbuild.py:244-258``) on keys that share prefixes, so that
  every one of the five key columns decides some pair, on shuffled rows and
  on rows staged as the device build stages them (doc-grouped, pads at the
  tail); and the kernel's pass plan (``sort_passes``): the radix passes it
  keeps, run as stable digit sorts, give the same rows, and it skips the
  doc passes on staged rows and the digits with one bin in every row.
- SH-stats (``shard_stats``) against the reference's
  ``global_stats_step`` and ``device_doc_offsets`` on the 8-device mesh.

Tolerance: none.  Every comparison is of exact bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch.ops import shard_kernels as sk  # noqa: E402

torch.set_num_threads(2)

_INT_MAX = np.iinfo(np.int32).max


def merge_inputs(gen, d, q, w, n_fin=None):
    """[D, Q, W] scores and local ids, and the [D] int64 doc offsets, as the
    sharded bodies hand them over: a few distinct score values (ties within
    and across shards), zeros, ``-inf`` pads carrying arbitrary local ids,
    each row sorted into merge order (score descending, then the rebased id
    ascending: a run as S2 or Block-Max leaves it)."""
    values = np.array([0.0, 0.5, 1.25, 1.25, 3.0, 7.5, 7.5], dtype=np.float32)
    scores = gen.choice(values, size=(d, q, w)).astype(np.float32)
    ids = np.zeros((d, q, w), dtype=np.int32)
    span = max(1000, 2 * w)  # shard s holds global ids [s * span, (s + 1) * span)
    offsets = np.arange(d, dtype=np.int64) * span
    for s in range(d):
        for qi in range(q):
            ids[s, qi] = gen.choice(span, size=w, replace=False)
    fin = gen.integers(0, w + 1, size=(d, q)) if n_fin is None else np.full((d, q), n_fin)
    pad = np.arange(w)[None, None, :] >= fin[:, :, None]
    scores[pad] = -np.inf
    gids = np.where(np.isfinite(scores), ids.astype(np.int64) + offsets[:, None, None], _INT_MAX)
    order = np.lexsort((gids, -scores.astype(np.float64)), axis=2)
    return (
        np.take_along_axis(scores, order, 2),
        np.take_along_axis(ids, order, 2),
        offsets,
    )


def reference_merge(scores, ids, offsets, kk, widths=None):
    """The reference's rebase and merge, verbatim (``parallel/shard.py:820-832``)
    on each shard's padded top-k: shard ``d``'s slots past ``widths[d]``
    (and past ``W``, up to ``kk``) are ``-inf`` pads."""
    import jax
    import jax.numpy as jnp

    dd, q, w = scores.shape
    widths = [w] * dd if widths is None else widths
    k = max(w, kk)
    l_scores = np.full((dd, q, k), -np.inf, dtype=np.float32)
    l_ids = np.zeros((dd, q, k), dtype=np.int32)
    for d, wd in enumerate(widths):
        l_scores[d, :, :wd] = scores[d, :, :wd]
        l_ids[d, :, :wd] = ids[d, :, :wd]
    doc_offset = jnp.asarray(offsets.astype(np.int32))[:, None, None]
    a_scores = jnp.asarray(l_scores)
    a_ids = jnp.where(
        jnp.isfinite(a_scores), jnp.asarray(l_ids).astype(jnp.int32) + doc_offset, _INT_MAX
    )
    c_scores = jnp.moveaxis(a_scores, 0, 1).reshape(-1, dd * k)
    c_ids = jnp.moveaxis(a_ids, 0, 1).reshape(-1, dd * k)
    neg, gid_s = jax.lax.sort((-c_scores, c_ids), num_keys=2)
    return np.asarray(-neg[:, :kk]), np.asarray(gid_s[:, :kk])


def port_merge(scores, ids, offsets, kk, widths=None):
    """``shard_merge`` on CPU tensors, as numpy (scores, ids)."""
    widths = [scores.shape[2]] * scores.shape[0] if widths is None else widths
    out = sk.shard_merge(
        torch.from_numpy(scores), torch.from_numpy(ids), widths, torch.from_numpy(offsets), kk
    )
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, scores.shape[1], kk)
    got_s, got_i = sk.merged_pair(out)
    return got_s.numpy(), got_i.numpy()


def assert_same_merge(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


def _table16():
    """16 keys that take one of two words in each column (one below 2^31,
    one above, so the order is unsigned)."""
    import itertools

    per_col = ((1, 0xFFFFFFFE), (0x7FFFFFFF, 0x80000000), (0, 0xFFFFFFFF), (5, 0x90000000))
    return np.array(list(itertools.product(*per_col)), dtype=np.uint32)  # [16, 4]


def sort_columns(gen, d, p, fill, staged=False):
    """Six [D, P] columns (k0-k3 u32, doc i32, tf u32) of ``fill`` real
    postings a row in no order, then pads (all-ones keys, doc INT_MAX,
    tf 0).  The 16 keys of ``_table16``, and every row holds each key with
    doc 0 and the first key with doc 1 as well: every one of the five key
    columns decides some adjacent pair.  (key, doc) pairs are unique within
    a row.  ``staged``: the real postings grouped by ascending doc (a doc's
    keys in no order) and the pads at the tail, as the device build stages
    them, in place of a permuted row."""
    table = _table16()
    cols = np.zeros((6, d, p), dtype=np.uint32)
    cols[:4] = 0xFFFFFFFF
    cols[4] = _INT_MAX
    forced = np.array([[t, 0] for t in range(16)] + [[0, 1]], dtype=np.int64)
    for s in range(d):
        extra = np.stack([gen.integers(0, 16, size=2 * fill), gen.integers(2, 60, size=2 * fill)], 1)
        extra = np.unique(extra, axis=0)[: fill - forced.shape[0]]
        pairs = np.concatenate([forced, extra])
        n = pairs.shape[0]
        cols[:4, s, :n] = table[pairs[:, 0]].T
        cols[4, s, :n] = pairs[:, 1]
        cols[5, s, :n] = gen.integers(1, 1 << 20, size=n)
        if staged:
            order = np.argsort(gen.permutation(n), kind="stable")
            order = order[np.argsort(cols[4, s, :n][order], kind="stable")]
            cols[:, s, :n] = cols[:, s, order]
        else:
            cols[:, s] = cols[:, s, gen.permutation(p)]
    return [c.view(np.int32) for c in cols]


# Layouts of ``layout_columns``: the staged rows of the card tests.
LAYOUTS = ("grouped", "one_key", "k3_only", "single_bin")


def _key_table(gen, kind):
    """[n_keys, 4] u32 term keys of ``layout_columns``, none all-ones."""
    if kind in ("grouped", "one_key"):
        return _table16()
    table = gen.integers(0, 0xFFFFFFFF, size=(64, 4), dtype=np.uint32)
    if kind == "k3_only":
        table[:, :3] = 0xFFFFFFFF  # k0-k2 those of the pads
    else:  # single_bin: k1's third byte is the pads' in every key
        table[:, 1] |= np.uint32(0x00FF0000)
    return np.unique(table, axis=0)


def layout_columns(gen, d, p, fill, kind, shuffled=False):
    """Six [D, P] columns of at most ``fill`` postings a row as the device
    build stages them (``parallel/devbuild.py``): unique (key, doc) pairs
    grouped by ascending doc, then the pads (all-ones keys, doc INT_MAX,
    tf 0); ``shuffled`` permutes each whole row, pads included, so the doc
    column is no longer in order.  ``kind``: "grouped" (``_table16``'s keys
    over docs from -fill/8 up, so doc's sign matters), "one_key" (one key in
    every doc: a long run of one term), "k3_only" (keys that differ in k3
    alone, k0-k2 the pads'), "single_bin" (k1's third byte 0xFF in every
    key and pad: that digit has one bin in every row)."""
    table = _key_table(gen, kind)
    n_keys = len(table)
    n_docs = max(2, fill // 4)
    cols = np.zeros((6, d, p), dtype=np.uint32)
    cols[:4] = 0xFFFFFFFF
    cols[4] = _INT_MAX
    for s in range(d):
        codes = gen.permutation(np.unique(gen.integers(0, n_keys * n_docs, size=2 * fill)))
        if kind == "one_key":
            run = np.arange(n_docs, dtype=np.int64) * n_keys  # key 0 in every doc
            codes = np.concatenate([run, np.setdiff1d(codes, run)])
        codes = codes[:fill]
        key, doc = codes % n_keys, codes // n_keys
        if kind == "grouped":
            doc = doc - n_docs // 2
        order = np.argsort(doc, kind="stable")
        n = codes.size
        cols[:4, s, :n] = table[key[order]].T
        cols[4, s, :n] = (doc[order] & 0xFFFFFFFF).astype(np.uint32)
        cols[5, s, :n] = gen.integers(1, 1 << 20, size=n)
        if shuffled:
            cols[:, s] = cols[:, s, gen.permutation(p)]
    return [c.view(np.int32) for c in cols]


def census_of(cols):
    """``posting_sort``'s census of six [D, P] int32 columns, as its kernel
    writes it: per key word the OR of its complement and its OR, then 1
    where the doc column decreases somewhere."""
    words = [np.asarray(c).view(np.uint32).astype(np.int64) for c in cols[:5]]
    out = np.zeros((words[0].shape[0], 11), dtype=np.int64)
    for w, x in enumerate(words):
        out[:, w] = np.bitwise_or.reduce(~x & 0xFFFFFFFF, axis=1)
        out[:, 5 + w] = np.bitwise_or.reduce(x, axis=1)
    doc = np.asarray(cols[4])
    out[:, 10] = (doc[:, 1:] < doc[:, :-1]).any(axis=1)
    return out


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


@pytest.mark.parametrize("d,q,w,kk", [(1, 3, 8, 8), (2, 5, 16, 16), (8, 7, 16, 16), (8, 4, 16, 5), (2, 6, 3, 6)])
def test_shard_merge_plain_matches_reference(gen, d, q, w, kk):
    scores, ids, offsets = merge_inputs(gen, d, q, w)
    assert_same_merge(port_merge(scores, ids, offsets, kk), reference_merge(scores, ids, offsets, kk))


@pytest.mark.parametrize(
    "widths,q,w,kk",
    [
        ((5,), 4, 8, 8),  # D = 1, a width below kk
        ((0, 3), 5, 4, 4),  # a width-0 shard
        ((16, 0, 9, 16, 1, 0, 16, 4), 6, 16, 16),  # D = 8, mixed widths
        ((16, 0, 9, 16, 1, 0, 16, 4), 6, 16, 7),  # kk < D * w
        ((2, 2), 3, 2, 16),  # kk > D * w: the merged rows end in pads
        ((0, 0, 0), 2, 4, 4),  # no shard offered anything
    ],
)
def test_shard_merge_widths_match_reference(gen, widths, q, w, kk):
    # Slots past a shard's width hold garbage the merge must not read.
    scores, ids, offsets = merge_inputs(gen, len(widths), q, w)
    for d, wd in enumerate(widths):
        scores[d, :, wd:] = 9.0
        ids[d, :, wd:] = 3
    got = port_merge(scores, ids, offsets, kk, list(widths))
    assert_same_merge(got, reference_merge(scores, ids, offsets, kk, widths))


def test_shard_merge_ties_across_shards_go_to_the_lower_id(gen):
    scores = np.full((8, 1, 2), -np.inf, dtype=np.float32)
    ids = np.zeros((8, 1, 2), dtype=np.int32)
    offsets = np.zeros(8, dtype=np.int64)
    for s in range(8):
        scores[s, 0, 0] = 2.0
        ids[s, 0, 0] = 7 - s  # the shard order is the reverse of the id order
    got = port_merge(scores, ids, offsets, 4)
    assert got[1][0].tolist() == [0, 1, 2, 3] and (got[0] == 2.0).all()
    assert_same_merge(got, reference_merge(scores, ids, offsets, 4))


def test_shard_merge_rebases_finite_scores_only(gen):
    # The reference's g_ids: id + offset where the score is finite; +inf,
    # -inf and their local ids become INT_MAX.
    scores = np.array([[[np.inf, 4.0, 1.0, -np.inf]], [[4.0, 2.0, -np.inf, -np.inf]]], np.float32)
    ids = np.array([[[5, 7, 2, 1]], [[0, 9, 3, 8]]], dtype=np.int32)
    offsets = np.array([0, 100], dtype=np.int64)
    got = port_merge(scores, ids, offsets, 8)
    assert got[1][0].tolist() == [_INT_MAX, 7, 100, 109, 2] + [_INT_MAX] * 3
    assert_same_merge(got, reference_merge(scores, ids, offsets, 8))


def test_shard_merge_all_pads(gen):
    scores = np.full((2, 3, 4), -np.inf, dtype=np.float32)
    ids = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    offsets = np.array([0, 50], dtype=np.int64)
    got = port_merge(scores, ids, offsets, 4)
    assert_same_merge(got, reference_merge(scores, ids, offsets, 4))
    assert (got[1] == _INT_MAX).all()


@pytest.mark.parametrize("fault", ["swapped", "tie_ids_down", "finite_after_pad"])
def test_shard_merge_rejects_runs_out_of_merge_order(gen, fault):
    scores, ids, offsets = merge_inputs(gen, 3, 4, 8, n_fin=6)
    if fault == "swapped":
        scores[1, 2, [0, 5]] = scores[1, 2, [5, 0]] + np.float32([0.0, 1.0])
    elif fault == "tie_ids_down":
        # In order by score; the tie of the first two goes to the higher id.
        scores[2, 1] = [3.0, 3.0, 1.0, 0.5, 0.5, 0.0, -np.inf, -np.inf]
        ids[2, 1] = [8, 4, 1, 2, 3, 5, 0, 0]
    else:
        scores[0, 3, 7] = 0.25  # a finite score after the -inf pads
    args = (torch.from_numpy(scores), torch.from_numpy(ids), [8] * 3, torch.from_numpy(offsets), 8)
    with pytest.raises(ValueError, match="merge order"):
        sk.shard_merge_plain(*args)
    with pytest.raises(ValueError, match="merge order"):
        sk.shard_merge(*args)


def test_merge_keys_round_trip(gen):
    scores, ids, _ = merge_inputs(gen, 2, 3, 8)
    s, i = torch.from_numpy(scores), torch.from_numpy(ids)
    back_s, back_i = sk._unmerge_keys(sk.merge_keys(s, i))
    assert torch.equal(back_s.view(torch.int32), s.view(torch.int32))
    assert torch.equal(back_i, i)


def test_shard_merge_rejects_bad_inputs():
    s = torch.zeros((2, 3, 4))
    i = torch.zeros((2, 3, 4), dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        sk.shard_merge(s.double(), i, [4, 4], off, 4)
    with pytest.raises(ValueError):
        sk.shard_merge(s, i[:, :, :3], [3, 3], off, 4)
    with pytest.raises(ValueError):
        sk.shard_merge(s, i, [4, 5], off, 4)  # a width past W
    with pytest.raises(ValueError):
        sk.shard_merge(s, i, [4], off, 4)  # a width a shard
    with pytest.raises(TypeError):
        sk.shard_merge(s, i, [4, 4], off.int(), 4)
    with pytest.raises(ValueError):
        sk.shard_merge(s, i, [4, 4], off, 0)


@pytest.mark.parametrize(
    "d,p,fill,staged",
    [(1, 64, 40, False), (3, 256, 200, False), (8, 512, 300, False),
     (1, 64, 40, True), (3, 256, 200, True), (8, 512, 300, True)],
    ids=["1-64-40", "3-256-200", "8-512-300",
         "staged-1-64-40", "staged-3-256-200", "staged-8-512-300"],
)
def test_posting_sort_plain_matches_reference(gen, d, p, fill, staged):
    import jax
    import jax.numpy as jnp

    cols = sort_columns(gen, d, p, fill, staged)
    # The staged rows are the layout whose doc passes the kernel skips.
    assert census_of(cols)[:, 10].any() != staged
    dtypes = (np.uint32,) * 4 + (np.int32, np.uint32)
    ref = jax.lax.sort(
        tuple(jnp.asarray(c.view(t)) for c, t in zip(cols, dtypes)),
        num_keys=5,
        dimension=-1,
    )
    got = sk.posting_sort([torch.from_numpy(c.copy()) for c in cols])
    for g, r, t in zip(got, ref, dtypes):
        np.testing.assert_array_equal(g.numpy().view(t), np.asarray(r))
    # Every key column decides some adjacent pair of the sorted rows.
    k = [g.numpy().view(np.uint32).astype(np.int64) for g in got[:5]]
    decided = set()
    for s in range(d):
        for j in range(fill - 1):
            for c in range(5):
                if k[c][s, j] != k[c][s, j + 1]:
                    decided.add(c)
                    break
    assert decided == {0, 1, 2, 3, 4}


def radix_by_plan(cols, plan):
    """The kernel's passes on the CPU: each ``(word, shift)`` of ``plan`` a
    stable sort of every row by that 8-bit digit (doc's sign bit flipped)."""
    cols = [np.asarray(c).copy() for c in cols]
    for word, shift in plan:
        x = cols[word].view(np.uint32)
        if word == 4:
            x = x ^ np.uint32(0x80000000)
        digit = (x >> np.uint32(shift)) & np.uint32(0xFF)
        order = np.argsort(digit, axis=1, kind="stable")
        cols = [np.take_along_axis(c, order, 1) for c in cols]
    return cols


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_sort_passes_skip_exactly(gen, kind, shuffled):
    cols = layout_columns(gen, 3, 1024, 700, kind, shuffled)
    plan = sk.sort_passes(census_of(cols))
    want = sk.posting_sort_plain([torch.from_numpy(c) for c in cols])
    for g, w in zip(radix_by_plan(cols, plan), want):
        np.testing.assert_array_equal(g, w.numpy())
    words = {w for w, _ in plan}
    # Staged rows skip the four doc passes; a shuffled row runs them.
    assert (4 in words) == shuffled
    assert len(plan) <= (20 if shuffled else 16)
    if kind == "k3_only":
        assert words - {4} == {3}
    if kind == "single_bin":
        assert (1, 16) not in plan and (1, 8) in plan
    if kind in ("grouped", "one_key"):
        assert len(plan) == (20 if shuffled else 16)  # every key byte varies


def test_posting_sort_is_in_place_and_checks_shapes(gen):
    cols = [torch.from_numpy(c.copy()) for c in sort_columns(gen, 2, 64, 30)]
    ptrs = [c.data_ptr() for c in cols]
    out = sk.posting_sort(cols)
    assert [c.data_ptr() for c in out] == ptrs
    with pytest.raises(ValueError):
        sk.posting_sort([c[:, :48].contiguous() for c in cols])
    with pytest.raises(ValueError):
        sk.posting_sort(cols[:5])
    with pytest.raises(TypeError):
        sk.posting_sort([c.long() for c in cols])


@pytest.fixture(scope="module")
def mesh8():
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("d",))


def test_shard_stats_plain_matches_reference(mesh8):
    from vectorchord_bm25_tpu.parallel.devbuild import device_doc_offsets
    from vectorchord_bm25_tpu.parallel.shard import ShardedIndex as RefShardedIndex
    from vectorchord_bm25_tpu_torch.parallel.shard import ShardedIndex

    from test_sealed import make_docs

    gen = np.random.default_rng(7)
    ref = RefShardedIndex.build(make_docs(gen, 203, vocab=12), 8, mesh=mesh8)
    deleted = gen.random(203) < 0.2
    ref.set_deleted(deleted)
    port = ShardedIndex.from_reference(ref, device="cpu")
    assert port.global_stats_step() == ref.global_stats_step()

    partial, offsets = sk.shard_stats(
        port.dev_doc_fn, port.dev_doc_live, port.dev_n_local
    )
    counts = np.array([v.segment.n_docs for v in ref.views], dtype=np.int64)
    np.testing.assert_array_equal(
        offsets.numpy()[:-1], device_doc_offsets(counts, mesh8)
    )
    assert int(offsets[-1]) == ref.n_docs
    assert int(partial.sum().item()) == ref.global_stats_step()[1]
    # Each shard's partial sum is the reference's lengths summed on the host.
    from vectorchord_bm25_tpu.models.fieldnorm import FIELDNORM_TO_LENGTH

    lengths = FIELDNORM_TO_LENGTH.astype(np.float64)[np.asarray(ref.dev_doc_fn)]
    want = (lengths * np.asarray(ref.dev_doc_live).astype(np.float64)).sum(axis=1)
    np.testing.assert_array_equal(partial.numpy(), want)


@pytest.mark.parametrize("d,m", [(1, 17), (3, 262_145)])
def test_shard_stats_plain_sums_largest_lengths_exactly(d, m):
    # Every slot holds the length table's largest entries, so the sums come
    # nearest 2^53; numpy's integer sum is the exact answer.
    from vectorchord_bm25_tpu_torch.models.fieldnorm import FIELDNORM_TO_LENGTH

    table = FIELDNORM_TO_LENGTH.astype(np.int64)
    fn = np.full((d, m), 255, dtype=np.uint8)
    fn[:, ::3] = 254
    live = np.ones((d, m), dtype=np.float32)
    live[-1, 1::7] = 0.0
    partial, _ = sk.shard_stats_plain(
        torch.from_numpy(fn), torch.from_numpy(live), torch.zeros(d, dtype=torch.int64)
    )
    want = (table[fn] * live.astype(np.int64)).sum(axis=1)
    assert want.max() < 2**53 and table[255] > 2**30
    assert partial.dtype == torch.float64
    assert partial.numpy().astype(np.int64).tolist() == want.tolist()
    np.testing.assert_array_equal(partial.numpy(), want.astype(np.float64))


def test_length_table_is_uploaded_once():
    first = sk._length_table(torch.device("cpu"))
    assert sk._length_table("cpu") is first
    assert first.dtype == torch.float64 and first.shape == (256,)


def test_shard_stats_empty_rows_scan_counts():
    counts = torch.tensor([5, 0, 7, 1], dtype=torch.int64)
    partial, offsets = sk.shard_stats(
        torch.zeros((4, 0), dtype=torch.uint8), torch.zeros((4, 0)), counts
    )
    assert offsets.tolist() == [0, 5, 5, 12, 13]
    assert partial.tolist() == [0.0] * 4
