"""The port's CUDA kernel on the card, against its plain PyTorch version.

Marked ``cuda``: each test skips unless torch sees a CUDA device (nvcc
builds the kernel at first use).  A CUDA install need not have jax, so run
these without the jax-forcing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.ranges import build_range_index  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import build_sealed_segment  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Query  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import score_kernel  # noqa: E402
from vectorchord_bm25_tpu_torch.search.blockmax import BlockMaxEngine  # noqa: E402

from test_sealed import make_docs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


@pytest.mark.parametrize("q,t,c,rs", [(2, 3, 4, 128), (64, 4, 32, 128), (5, 2, 3, 256), (3, 1, 2, 32)])
def test_kernel_matches_plain_with_collisions(card, gen, q, t, c, rs):
    p = 8192
    post_local = torch.from_numpy(gen.integers(0, rs, size=p).astype(np.uint8))
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32))
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(q, t, c)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(q, t, c)).astype(np.int32))
    args = [x.to(card) for x in (post_impact, post_local, starts, lens)]
    before = score_kernel.LAUNCHES
    got = score_kernel.fused_range_scores(*args, rs=rs)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES == before + 1
    want = score_kernel.fused_range_scores_plain(*args, rs=rs)
    # Colliding slots add in atomic order on both sides.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    cpu = score_kernel.fused_range_scores(
        post_impact, post_local, starts, lens, rs=rs
    )
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-6)


def test_kernel_drops_out_of_range_slots(card, gen):
    p, rs = 8192, 64
    post_local = torch.from_numpy(gen.integers(0, 256, size=p).astype(np.uint8))
    post_impact = torch.from_numpy((gen.random(p) * 8).astype(np.float32))
    starts = torch.from_numpy(gen.integers(0, p - rs, size=(8, 3, 16)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(0, rs + 1, size=(8, 3, 16)).astype(np.int32))
    args = [x.to(card) for x in (post_impact, post_local, starts, lens)]
    got = score_kernel.fused_range_scores(*args, rs=rs)
    torch.cuda.synchronize()
    want = score_kernel.fused_range_scores_plain(*args, rs=rs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_zero_lengths(card):
    imp = torch.rand(1024, device=card)
    loc = torch.zeros(1024, dtype=torch.uint8, device=card)
    st = torch.zeros((1, 2, 2), dtype=torch.int32, device=card)
    out = score_kernel.fused_range_scores(imp, loc, st, st, rs=128)
    assert out.shape == (1, 2, 128) and not out.any()


def test_kernel_rejects_wrong_dtype(card):
    imp = torch.rand(1024, device=card, dtype=torch.float64)
    loc = torch.zeros(1024, dtype=torch.uint8, device=card)
    st = torch.zeros((1, 2, 2), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        score_kernel.fused_range_scores(imp, loc, st, st, rs=128)


@pytest.mark.parametrize("n_docs,vocab,range_size", [(3000, 40, 128), (1000, 30, 64)])
def test_engine_on_card_equals_cpu(card, gen, n_docs, vocab, range_size):
    seg = build_sealed_segment(make_docs(gen, n_docs, vocab=vocab))
    ri = build_range_index(seg, range_size=range_size)
    on_card = BlockMaxEngine(seg, ri, chunk=4, device=card)
    on_cpu = BlockMaxEngine(seg, ri, chunk=4, device="cpu")
    deleted = gen.random(n_docs) < 0.1
    on_card.set_deleted(deleted)
    on_cpu.set_deleted(deleted)
    fmask = gen.random(n_docs) < 0.7
    queries = [
        Query.from_int_ids(gen.integers(0, vocab, size=int(n)).tolist())
        for n in gen.integers(1, 7, size=48)
    ]
    for kw in ({}, {"filter_mask": fmask}):
        before = score_kernel.LAUNCHES
        got = on_card.search(queries, 10, **kw)
        assert score_kernel.LAUNCHES > before
        want = on_cpu.search(queries, 10, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert on_card.memory_report() == on_cpu.memory_report()
