"""Port's fused range-score accumulation vs the reference Pallas kernel.

The reference runs in Pallas interpret mode on the CPU, as
tests/test_score_kernel.py runs it; the port runs its plain PyTorch
version, which is what a CPU tensor dispatches to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.ops.score_kernel import (  # noqa: E402
    fused_range_scores as ref_fused_range_scores,
)
from vectorchord_bm25_tpu_torch.ops import score_kernel  # noqa: E402

from test_sealed import make_docs  # noqa: E402

torch.set_num_threads(2)


def index_windows(rng, n_docs=2000, vocab=40, rs=128, q=16, t=4, c=8):
    """[Q, T, C] windows of real (term, range) groups, as the Block-Max
    engine hands them to the kernel: absent groups get length 0."""
    seg = build_sealed_segment(make_docs(rng, n_docs, vocab=vocab))
    ri = build_range_index(seg, range_size=rs)
    starts = np.zeros((q, t, c), dtype=np.int32)
    lens = np.zeros((q, t, c), dtype=np.int32)
    for qi in range(q):
        terms = rng.choice(seg.n_tokens, size=t, replace=False)
        ranges = rng.choice(ri.n_ranges, size=min(c, ri.n_ranges), replace=False)
        for ti, tid in enumerate(terms):
            lo, hi = ri.token_tr_start[tid], ri.token_tr_start[tid + 1]
            term_ranges = ri.tr_range[lo:hi]
            for ci, r in enumerate(ranges):
                j = np.searchsorted(term_ranges, r)
                if j < term_ranges.size and term_ranges[j] == r:
                    starts[qi, ti, ci] = ri.tr_start[lo + j]
                    lens[qi, ti, ci] = ri.tr_len[lo + j]
    assert lens.any()
    return ri.post_impact, ri.post_local, starts, lens


def port_scores(post_impact, post_local, starts, lens, rs):
    return score_kernel.fused_range_scores(
        torch.from_numpy(post_impact),
        torch.from_numpy(post_local),
        torch.from_numpy(starts),
        torch.from_numpy(lens),
        rs=rs,
    ).numpy()


@pytest.mark.parametrize("rs", [128, 64])
def test_index_windows_bit_equal(rng, rs):
    # Unique slots per (term, range) group and ascending-t accumulation:
    # the plain version equals the one-hot matmul bit for bit.
    post_impact, post_local, starts, lens = index_windows(rng, rs=rs)
    got = port_scores(post_impact, post_local, starts, lens, rs)
    want = np.asarray(
        ref_fused_range_scores(
            post_impact, post_local, starts, lens, rs=rs, interpret=True
        )
    )
    assert got.shape == want.shape == (16, 8, rs)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("q,t,c,rs", [(2, 3, 4, 128), (1, 1, 2, 128)])
def test_random_collisions_match_reference(rng, q, t, c, rs):
    # The shapes and inputs of tests/test_score_kernel.py: random slots
    # collide inside one window, so sums may round in another order.
    p = 4096
    post_local = rng.integers(0, rs, size=p).astype(np.uint8)
    post_impact = (rng.random(p) * 8).astype(np.float32)
    starts = rng.integers(0, p - rs, size=(q, t, c)).astype(np.int32)
    lens = rng.integers(0, rs + 1, size=(q, t, c)).astype(np.int32)
    got = port_scores(post_impact, post_local, starts, lens, rs)
    want = np.asarray(
        ref_fused_range_scores(
            post_impact, post_local, starts, lens, rs=rs, interpret=True
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_out_of_range_slots_dropped(rng):
    # Slots at or above RS match no one-hot column in the reference; the
    # port drops them too instead of writing past its accumulator.
    p, rs = 4096, 64
    post_local = rng.integers(0, 256, size=p).astype(np.uint8)
    post_impact = (rng.random(p) * 8).astype(np.float32)
    starts = rng.integers(0, p - rs, size=(3, 2, 4)).astype(np.int32)
    lens = rng.integers(0, rs + 1, size=(3, 2, 4)).astype(np.int32)
    got = port_scores(post_impact, post_local, starts, lens, rs)
    want = np.asarray(
        ref_fused_range_scores(
            post_impact, post_local, starts, lens, rs=rs, interpret=True
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_zero_lengths(rng):
    p = 1024
    post_local = rng.integers(0, 128, size=p).astype(np.uint8)
    post_impact = (rng.random(p) * 8).astype(np.float32)
    starts = np.zeros((1, 2, 2), dtype=np.int32)
    lens = np.zeros((1, 2, 2), dtype=np.int32)
    out = port_scores(post_impact, post_local, starts, lens, 128)
    assert out.shape == (1, 2, 128)
    assert np.all(out == 0)


def test_cpu_call_launches_nothing(rng):
    before = score_kernel.LAUNCHES
    port_scores(*index_windows(rng, n_docs=300, q=2, c=2), 128)
    assert score_kernel.LAUNCHES == before


@pytest.mark.parametrize(
    "field,bad",
    [
        ("post_impact", lambda x: x.double()),
        ("post_local", lambda x: x.int()),
        ("starts", lambda x: x.long()),
        ("lens", lambda x: x[:, :, ::2]),
    ],
)
def test_rejects_wrong_inputs(rng, field, bad):
    args = dict(
        zip(
            ("post_impact", "post_local", "starts", "lens"),
            (torch.from_numpy(a) for a in index_windows(rng, n_docs=300, q=2, c=4)),
        )
    )
    args[field] = bad(args[field])
    with pytest.raises((TypeError, ValueError)):
        score_kernel.fused_range_scores(**args, rs=128)


def test_other_devices_raise():
    # Only a CPU tensor takes the plain version; nothing else falls back.
    imp = torch.zeros(256, device="meta")
    loc = torch.zeros(256, dtype=torch.uint8, device="meta")
    st = torch.zeros((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        score_kernel.fused_range_scores(imp, loc, st, st, rs=128)


def test_failed_build_raises(monkeypatch, tmp_path):
    # A compiler that fails raises with its exit code; nothing falls back.
    from vectorchord_bm25_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.library()
    finally:
        _build.library.cache_clear()
    assert list(tmp_path.iterdir()) == []  # no half-written library left


def test_bf16_impacts_not_ported(rng):
    # Ported now: bf16 impacts (the same bits as the reference's cast) are
    # widened exactly, so the result equals the Pallas kernel's bit for bit.
    import jax.numpy as jnp

    post_impact, post_local, starts, lens = index_windows(rng)
    ref_imp = jnp.asarray(post_impact, dtype=jnp.bfloat16)
    imp = torch.from_numpy(post_impact).to(torch.bfloat16)
    assert np.array_equal(
        imp.view(torch.int16).numpy(), np.asarray(ref_imp).view(np.int16)
    )
    got = score_kernel.fused_range_scores(
        imp, torch.from_numpy(post_local), torch.from_numpy(starts),
        torch.from_numpy(lens), rs=128,
    ).numpy()
    want = np.asarray(
        ref_fused_range_scores(
            ref_imp, post_local, starts, lens, rs=128, interpret=True
        )
    )
    assert np.array_equal(got, want)


def _unique_slot_windows(rng, q=6, t=4, c=8, rs=64, slot_hi=256, p=8192):
    """Windows whose slots are unique (as on index data) and drawn from
    [0, slot_hi): with slot_hi > rs some land in [RS, 256) and are dropped."""
    post_local = np.concatenate(
        [rng.permutation(slot_hi)[:rs] for _ in range(p // rs)]
    ).astype(np.uint8)
    post_impact = (rng.random(post_local.size) * 8).astype(np.float32)
    starts = (rng.integers(0, post_local.size // rs - 1, (q, t, c)) * rs).astype(np.int32)
    lens = rng.integers(0, rs + 1, (q, t, c)).astype(np.int32)
    return post_impact, post_local, starts, lens


def _design_inactive(rng):
    post_impact, post_local, starts, lens = index_windows(rng)
    lens[::2] = 0  # every other query has no window at all
    return post_impact, post_local, starts, lens, 128, {}


def _design_strided(rng):
    return (*index_windows(rng), 128, {"stride_extra": 132})


def _design_bf16(rng):
    return (*index_windows(rng), 128, {"bf16": True})


def _design_slots_past_rs(rng):
    return (*_unique_slot_windows(rng), 64, {})


# The cases P1's design must keep (csrc/score_kernel.cu): queries whose
# windows are all empty (their rows are written as zeros), rows written at
# a stride wider than C*RS (the range sweep's accumulator), bf16 impacts,
# and slots in [RS, 256), which are dropped.
P1_DESIGN_CASES = {
    "all_inactive_queries": _design_inactive,
    "row_stride_wider_than_c_rs": _design_strided,
    "bf16_impacts": _design_bf16,
    "slots_past_rs": _design_slots_past_rs,
}


@pytest.mark.parametrize("case", list(P1_DESIGN_CASES))
def test_design_cases_equal_reference(rng, case):
    import jax.numpy as jnp

    post_impact, post_local, starts, lens, rs, opts = P1_DESIGN_CASES[case](rng)
    q, _, c = starts.shape
    ref_imp = jnp.asarray(post_impact, dtype=jnp.bfloat16) if opts.get("bf16") else post_impact
    imp = torch.from_numpy(post_impact)
    if opts.get("bf16"):
        imp = imp.to(torch.bfloat16)
    args = (imp, *(torch.from_numpy(a) for a in (post_local, starts, lens)))
    want = np.asarray(
        ref_fused_range_scores(ref_imp, post_local, starts, lens, rs=rs, interpret=True)
    )
    extra = opts.get("stride_extra", 0)
    if extra:
        wide = torch.full((q, c * rs + extra), -1.0)
        view = wide[:, extra // 2 : extra // 2 + c * rs]
        assert score_kernel.fused_range_scores(*args, rs=rs, out=view) is view
        got = view.reshape(q, c, rs).numpy()
        assert bool((wide[:, : extra // 2] == -1).all())
        assert bool((wide[:, extra // 2 + c * rs :] == -1).all())
    else:
        got = score_kernel.fused_range_scores(*args, rs=rs).numpy()
    assert np.array_equal(got, want)
    if case == "all_inactive_queries":
        assert not got[::2].any() and got[1::2].any()
    if case == "slots_past_rs":
        assert (post_local >= rs).any()
