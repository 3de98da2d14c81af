"""The port's span and counter recorder (``utils/tracing.py``) on a small
CPU index: off by default, the spans of a batch with their parents and
batch id, the counters, the profiler's timeline, results unchanged, and
the benchmark's readers of it (``portbench/metrics/``)."""

import ast
import glob
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch import ops  # noqa: E402
from vectorchord_bm25_tpu_torch.ops import stream_kernel, topk  # noqa: E402
from vectorchord_bm25_tpu_torch.search import stream as stream_mod  # noqa: E402
from vectorchord_bm25_tpu_torch.utils import tracing  # noqa: E402
from vectorchord_bm25_tpu_torch.utils.batchkeys import batch_lookup  # noqa: E402

torch.set_num_threads(2)

PORT = os.path.dirname(os.path.abspath(ops.__file__))


@pytest.fixture(autouse=True)
def recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def make_docs(rng, n, vocab=40):
    return [
        Document.from_int_ids(rng.integers(0, vocab, size=int(rng.integers(1, 30))).tolist())
        for _ in range(n)
    ]


QUERIES = [Query.from_int_ids([1, 2, 3]), Query.from_int_ids([5]), Query.from_int_ids([7, 30])]


def looked_up(engine, queries):
    """The batch as the engines' planning reads it: its lookup in the
    engine's token table and its query count."""
    return (*batch_lookup(engine.segment.lookup_tokens, queries), len(queries))


def hits_of(result):
    return [[(h.score, h.payload) for h in hits] for hits in result]


@pytest.fixture
def index():
    """A sealed segment of 300 docs and a growing segment whose device
    engine holds 20 docs and whose host tail holds 3."""
    rng = np.random.default_rng(7)
    idx = Bm25Index.build(make_docs(rng, 300), device="cpu")
    for j, doc in enumerate(make_docs(rng, 20)):
        idx.insert(doc, 1000 + j)
    idx.search_batch_async(QUERIES, 5)()
    for j, doc in enumerate(make_docs(rng, 3)):
        idx.insert(doc, 2000 + j)
    return idx


def test_off_by_default_records_nothing(index, monkeypatch):
    seen = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: seen.append(name))
    assert not tracing.active()
    assert tracing.span("vcbm25.x") is tracing.span("vcbm25.y")  # one shared no-op
    index.search_batch_async(QUERIES, 5)()
    index.insert(Document.from_int_ids([1, 2]), 3000)
    tracing.count("batches")
    snap = tracing.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": []}
    assert seen == []


DISPATCH = "vcbm25.facade.dispatch"
FINALIZE = "vcbm25.facade.finalize"
WANT = {
    DISPATCH,
    f"{DISPATCH}/vcbm25.facade.unbind",
    f"{DISPATCH}/vcbm25.facade.lookup",
    f"{DISPATCH}/vcbm25.growing.dispatch",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.growing.lookup",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.growing.tail",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.stream.dispatch",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.stream.dispatch/vcbm25.stream.lookup",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.stream.dispatch/vcbm25.stream.plan",
    f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.stream.dispatch/vcbm25.stream.plan/vcbm25.stream.launch",
    f"{DISPATCH}/vcbm25.stream.dispatch",
    f"{DISPATCH}/vcbm25.stream.dispatch/vcbm25.stream.lookup",
    f"{DISPATCH}/vcbm25.stream.dispatch/vcbm25.stream.plan",
    f"{DISPATCH}/vcbm25.stream.dispatch/vcbm25.stream.plan/vcbm25.stream.launch",
    FINALIZE,
    f"{FINALIZE}/vcbm25.stream.finalize",
    f"{FINALIZE}/vcbm25.stream.finalize/vcbm25.stream.wait",
    f"{FINALIZE}/vcbm25.growing.finalize",
    f"{FINALIZE}/vcbm25.growing.finalize/vcbm25.stream.finalize",
    f"{FINALIZE}/vcbm25.growing.finalize/vcbm25.stream.finalize/vcbm25.stream.wait",
    f"{FINALIZE}/vcbm25.facade.merge",
    f"{FINALIZE}/vcbm25.facade.hits",
}


def test_batch_spans_parents_and_self_times(index):
    tracing.enable()
    fin = index.search_batch_async(QUERIES, 5)
    result = fin()
    snap = tracing.snapshot()
    assert set(snap["spans"]) == WANT
    records = {r[0]: r for r in snap["records"]}
    assert len(records) == sum(s["count"] for s in snap["spans"].values())
    # One batch id; every parent is a recorded span that encloses its child.
    assert len({r[6] for r in records.values()}) == 1
    roots = [r for r in records.values() if r[4] is None]
    assert sorted(r[1] for r in roots) == [DISPATCH, FINALIZE]
    for sid, name, t0, t1, parent, thread, _ in records.values():
        assert t0 <= t1 and thread == threading.get_ident()
        if parent is not None:
            up = records[parent]
            assert up[2] <= t0 and t1 <= up[3]
    # Self times are >= 0 and add up to no more than their root.
    for root in (DISPATCH, FINALIZE):
        tree = {p: s for p, s in snap["spans"].items() if p.split("/")[0] == root}
        assert all(s["self_s"] >= 0 for s in tree.values())
        assert sum(s["self_s"] for s in tree.values()) <= tree[root]["total_s"] * (1 + 1e-9)
    c = snap["counters"]
    assert (c["batches"], c["queries"]) == (1, len(QUERIES))
    assert c["hits"] == sum(len(h) for h in result) > 0
    assert c["d2h_bytes"] > 0 and "growing_rebuilds" not in c
    # The tail's (query, posting) pairs: each query's sealed-known terms
    # against each tail doc's.
    grow = index.growing
    pairs = 0
    for q in QUERIES:
        tids = grow.sealed.lookup_tokens(q.keys)
        for doc_tids in grow._tid[grow._dev_engine_n :]:
            pairs += int(np.isin(doc_tids, tids[tids >= 0]).sum())
    assert c["growing_tail_pairs"] == pairs > 0


def test_results_bit_identical_on_and_off(index):
    off = hits_of(index.search_batch_async(QUERIES, 5)())
    tracing.enable()
    on = hits_of(index.search_batch_async(QUERIES, 5)())
    assert on == off and tracing.snapshot()["spans"]


def _dense_upload_bytes(engine, queries):
    lists = engine._layout(*looked_up(engine, queries))[0]
    return sum(
        sum(x.nbytes for x in (wsrc, q_start, w_ord))
        for _, wsrc, q_start, w_ord, _ in engine._dispatches(lists)
    )


def test_h2d_bytes_are_the_uploaded_arrays():
    rng = np.random.default_rng(11)
    idx = Bm25Index.build(make_docs(rng, 400), device="cpu")
    engine = idx.engine()
    want = _dense_upload_bytes(engine, QUERIES)
    assert want > 0
    tracing.enable()
    idx.search_batch_async(QUERIES, 5)()
    assert tracing.snapshot()["counters"]["h2d_bytes"] == want
    # A delete re-uploads the [N+1] f32 table of the sealed engine.
    idx.bulkdelete_payloads([3])
    tracing.reset()
    idx.search_batch_async(QUERIES, 5)()
    assert tracing.snapshot()["counters"]["h2d_bytes"] == want + 4 * (idx.sealed.n_docs + 1)


def test_kernel_calls_are_the_launch_counters_delta(index, monkeypatch):
    # The CPU versions bump no counter; the wrappers bump theirs on the card.
    def bumped(fn, module):
        def call(*args, **kwargs):
            module.LAUNCHES += 1
            return fn(*args, **kwargs)

        return call

    monkeypatch.setattr(stream_mod, "stream_dense_accumulate", bumped(stream_mod.stream_dense_accumulate, stream_kernel))
    monkeypatch.setattr(stream_mod, "dense_topk", bumped(stream_mod.dense_topk, topk))
    tracing.enable()
    before = ops.launch_count()
    index.search_batch_async(QUERIES, 5)()
    delta = ops.launch_count() - before
    # The sealed engine's one dense dispatch and the growing engine's: S1 and S2 each.
    assert delta == 4
    assert tracing.snapshot()["counters"]["kernel_calls"] == delta


def test_launch_count_reads_every_wrapper_counter():
    """Every ``ops/*.py`` module that defines a ``*LAUNCHES`` global is one
    that ``launch_count`` sums."""
    found = set()
    for path in glob.glob(os.path.join(PORT, "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id.endswith("LAUNCHES") for t in node.targets
            ):
                found.add(os.path.basename(path)[:-3])
    assert found == set(ops._WRAPPERS)
    for name in ops._WRAPPERS:
        __import__(f"vectorchord_bm25_tpu_torch.ops.{name}")
    want = sum(
        v
        for name in ops._WRAPPERS
        for k, v in vars(sys.modules[f"vectorchord_bm25_tpu_torch.ops.{name}"]).items()
        if k.endswith("LAUNCHES")
    )
    assert ops.launch_count() == want


def test_growing_rebuilds_step_at_the_tail_threshold():
    rng = np.random.default_rng(5)
    idx = Bm25Index.build(make_docs(rng, 100), device="cpu")
    tracing.enable()

    def rebuilds_after(n_inserts):
        for j in range(n_inserts):
            idx.insert(Document.from_int_ids([int(rng.integers(0, 40))]), 10_000 + len(idx.growing) + j)
        idx.search_batch_async(QUERIES, 5)()
        return tracing.snapshot()["counters"].get("growing_rebuilds", 0)

    assert rebuilds_after(10) == 1  # the first batch builds the engine over 10 docs
    # The tail is rebuilt into the engine once it exceeds max(512, min(n0 // 8, 4096)).
    assert rebuilds_after(512) == 1
    assert rebuilds_after(1) == 2
    paths = tracing.snapshot()["spans"]
    assert paths[f"{DISPATCH}/vcbm25.growing.dispatch/vcbm25.growing.rebuild"]["count"] == 2


def test_profiler_session_sees_the_spans(index, monkeypatch):
    seen = []
    original = torch.profiler.record_function

    def spy(name, *args):
        seen.append(name)
        return original(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not tracing.active()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.active()
        index.search_batch_async(QUERIES, 5)()
    assert not tracing.active()
    assert {DISPATCH, FINALIZE, "vcbm25.stream.wait", "vcbm25.facade.hits"} <= set(seen)
    assert all(name.startswith("vcbm25.") for name in seen)
    assert set(tracing.snapshot()["spans"]) == WANT


def test_threads_keep_their_own_stacks_and_lose_no_count():
    tracing.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n_spans = 16, 500

    def work():
        for _ in range(n_spans):
            with tracing.span("vcbm25.test.outer"):
                with tracing.span("vcbm25.test.inner"):
                    tracing.count("test")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = tracing.snapshot()
    assert snap["counters"]["test"] == n_threads * n_spans
    assert set(snap["spans"]) == {"vcbm25.test.outer", "vcbm25.test.outer/vcbm25.test.inner"}
    assert all(s["count"] == n_threads * n_spans for s in snap["spans"].values())
    records = {r[0]: r for r in snap["records"]}
    for r in records.values():
        if r[4] is not None and r[4] in records:
            assert records[r[4]][5] == r[5]  # a parent is on the child's thread


def test_ring_is_bounded(monkeypatch):
    import collections

    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=4))
    tracing.enable()
    for _ in range(10):
        with tracing.span("vcbm25.test"):
            pass
    snap = tracing.snapshot()
    assert len(snap["records"]) == 4 and snap["spans"]["vcbm25.test"]["count"] == 10


# The benchmark's readers of the recorder.


def _reader(name):
    from portbench import manifest

    return manifest.load_module("metrics", name)


def _run():
    from portbench.harness import RunData

    return RunData(cell="c", spans={}, counters={}, build_s=1.0)


SNAP = {
    "spans": {
        "vcbm25.facade.dispatch": {"total_s": 0.2},
        "vcbm25.facade.dispatch/vcbm25.stream.dispatch/vcbm25.stream.lookup": {"total_s": 0.01},
        "vcbm25.facade.dispatch/vcbm25.stream.dispatch/vcbm25.stream.plan": {"total_s": 0.05},
        "vcbm25.facade.dispatch/vcbm25.growing.dispatch": {"total_s": 0.09},
        "vcbm25.facade.dispatch/vcbm25.growing.dispatch/vcbm25.stream.dispatch/vcbm25.stream.plan": {"total_s": 0.02},
        "vcbm25.facade.dispatch/vcbm25.stream.dispatch/vcbm25.stream.maxscore/vcbm25.stream.ms_tier/vcbm25.stream.wait": {"total_s": 0.04},
        "vcbm25.facade.finalize/vcbm25.stream.finalize/vcbm25.stream.wait": {"total_s": 0.006},
        "vcbm25.facade.finalize/vcbm25.growing.finalize": {"total_s": 0.03},
        "vcbm25.facade.finalize/vcbm25.growing.finalize/vcbm25.stream.finalize/vcbm25.stream.wait": {"total_s": 0.003},
        "vcbm25.facade.finalize/vcbm25.facade.hits": {"total_s": 0.12},
        "vcbm25.facade.dispatch/vcbm25.blockmax.dispatch/vcbm25.blockmax.rounds": {"total_s": 0.09},
        "vcbm25.facade.dispatch/vcbm25.blockmax.dispatch/vcbm25.blockmax.rounds/vcbm25.blockmax.flag": {"total_s": 0.015},
    },
    "counters": {"batches": 3, "h2d_bytes": 3 * 2048, "kernel_calls": 18, "blockmax_rounds": 75},
}
WANT_READ = {
    "hits_ms": 40.0, "card_wait_ms": 3.0, "plan_ms": 20.0, "growing_ms": 40.0,
    "h2d_kib": 2.0, "kernel_calls": 6.0,
}
# The Block-Max engine's readers (read in the Block-Max cell alone).
WANT_READ_BLOCKMAX = {"bm_rounds": 25.0, "bm_loop_ms": 30.0, "bm_flag_ms": 5.0}
READERS = {**WANT_READ, **WANT_READ_BLOCKMAX}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_snapshot(name, monkeypatch):
    reader = _reader(name)
    program = sys.modules["portbench.metrics._program"]
    monkeypatch.setattr(program, "snapshot", lambda: SNAP)
    assert reader.read(_run()) == pytest.approx(READERS[name])
    # Nothing to read: no batch, or none of the metric's spans or counters.
    monkeypatch.setattr(program, "snapshot", lambda: {"spans": {}, "counters": {"batches": 3}, "records": []})
    assert reader.read(_run()) is None
    monkeypatch.setattr(program, "snapshot", lambda: dict(SNAP, counters={}))
    assert reader.read(_run()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_the_recorder(name, monkeypatch):
    # A program without utils/tracing.py, as the parent of this change.
    import vectorchord_bm25_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "vectorchord_bm25_tpu_torch.utils.tracing", None)
    assert _reader(name).read(_run()) is None


@pytest.mark.parametrize("name", sorted(WANT_READ_BLOCKMAX))
def test_blockmax_readers_read_nothing_without_the_engine(name, monkeypatch):
    # A stream cell's snapshot: no Block-Max span and no Block-Max counter.
    stream_only = {
        "spans": {p: v for p, v in SNAP["spans"].items() if "blockmax" not in p},
        "counters": {c: v for c, v in SNAP["counters"].items() if not c.startswith("blockmax")},
    }
    reader = _reader(name)
    monkeypatch.setattr(sys.modules["portbench.metrics._program"], "snapshot", lambda: stream_only)
    assert reader.read(_run()) is None


def test_traced_cpu_run_reports_the_recorder_metrics():
    """A whole traced run of the ingest cell at a CPU size: the profiled
    steps switch the recorder on, and every new reader finds its spans and
    counters there."""
    from portbench.tests.tiny import run_tiny

    # A window of several CPU steps, so the profiled steps (from 40% of it)
    # start inside it on a loaded host too.
    result, _ = run_tiny("trec-covid.ingest", trace=True, seconds=2.0)
    m = result["metrics"]
    assert set(WANT_READ) <= set(m)
    for name in ("hits_ms", "card_wait_ms", "plan_ms", "growing_ms", "h2d_kib"):
        assert m[name]["value"] > 0, name
    assert m["kernel_calls"]["value"] == 0  # the CPU versions bump no counter
    assert result["correct"]
    assert not tracing.active()


# The Block-Max engine's spans and counters.

BM = f"{DISPATCH}/vcbm25.blockmax.dispatch"
BM_WANT = {
    DISPATCH,
    f"{DISPATCH}/vcbm25.facade.unbind",
    f"{DISPATCH}/vcbm25.facade.lookup",
    BM,
    f"{BM}/vcbm25.blockmax.lookup",
    f"{BM}/vcbm25.blockmax.upload",
    f"{BM}/vcbm25.blockmax.bounds",
    f"{BM}/vcbm25.blockmax.rounds",
    f"{BM}/vcbm25.blockmax.rounds/vcbm25.blockmax.flag",
    FINALIZE,
    f"{FINALIZE}/vcbm25.blockmax.finalize",
    f"{FINALIZE}/vcbm25.blockmax.finalize/vcbm25.blockmax.wait",
    f"{FINALIZE}/vcbm25.facade.hits",
}


def blockmax_index(posting_mode):
    """600 docs in five 128-doc ranges, one candidate range a round."""
    rng = np.random.default_rng(13)
    idx = Bm25Index.build(
        make_docs(rng, 600, vocab=60), engine="blockmax",
        engine_options={"posting_mode": posting_mode, "chunk": 1}, device="cpu",
    )
    idx.engine()
    return idx


@pytest.mark.parametrize("posting_mode", ["tf", "impact"])
def test_blockmax_batch_spans_and_counters(posting_mode):
    idx = blockmax_index(posting_mode)
    engine = idx.engine()
    tracing.enable()
    result = idx.search_batch_async(QUERIES, 5)()
    snap = tracing.snapshot()
    assert set(snap["spans"]) == BM_WANT
    c, spans = snap["counters"], snap["spans"]
    rounds = engine.last_rounds
    assert rounds > 1
    assert c["blockmax_rounds"] == rounds
    # A flag read a round and the one that ends the loop.
    assert spans[f"{BM}/vcbm25.blockmax.rounds/vcbm25.blockmax.flag"]["count"] == rounds + 1
    for name in ("lookup", "upload", "bounds", "rounds"):
        assert spans[f"{BM}/vcbm25.blockmax.{name}"]["count"] == 1
    # The uploads: the query terms, their s0 in tf mode, the [N+1] filter.
    q_tid, _ = engine._prepare(*looked_up(engine, [idx._unbind(q) for q in QUERIES]))
    want = q_tid.nbytes + 4 * (idx.sealed.n_docs + 1) + (4 * q_tid.size if posting_mode == "tf" else 0)
    assert c["h2d_bytes"] == want
    assert c["d2h_bytes"] == 8 * len(QUERIES) * 8  # [Q, 8] f32 scores and i32 ids (k=5 bucketed)
    assert c["hits"] == sum(len(h) for h in result) > 0
    tracing.disable()
    tracing.reset()
    assert hits_of(idx.search_batch_async(QUERIES, 5)()) == hits_of(result)


@pytest.mark.parametrize("posting_mode", ["tf", "impact"])
def test_blockmax_off_records_nothing(posting_mode):
    idx = blockmax_index(posting_mode)
    idx.search_batch_async(QUERIES, 5)()
    assert tracing.snapshot() == {"spans": {}, "counters": {}, "records": []}


def test_blockmax_loop_cut_by_max_rounds_reads_a_flag_a_round():
    from vectorchord_bm25_tpu_torch.search import blockmax

    idx = blockmax_index("impact")
    e = idx.engine()
    q_tid, lmax = e._prepare(*looked_up(e, [idx._unbind(q) for q in QUERIES]))
    tracing.enable()
    _, _, rounds = blockmax._blockmax_kernel(
        e.dev_post_impact, e.dev_post_local, e.dev.doc_live, e._filter(None), e.dev_tr_range,
        e.dev_tr_start, e.dev_tr_ub, e.dev_token_tr_start, torch.from_numpy(q_tid),
        k=8, chunk=1, lmax=lmax, range_size=e.ranges.range_size, n_ranges=e.ranges.n_ranges,
        n_docs=e.dev.n_docs, max_rounds=2,
    )
    snap = tracing.snapshot()
    assert rounds == 2
    assert snap["counters"]["blockmax_rounds"] == 2
    assert snap["spans"]["vcbm25.blockmax.rounds/vcbm25.blockmax.flag"]["count"] == 2


def test_blockmax_rangescan_has_dispatch_and_finalize_only():
    idx = blockmax_index("impact")
    e = idx.engine()
    queries = [idx._unbind(q) for q in QUERIES]
    tracing.enable()
    e.search_rangescan_async(queries, 5)()
    snap = tracing.snapshot()
    assert set(snap["spans"]) == {
        "vcbm25.blockmax.dispatch", "vcbm25.blockmax.finalize", "vcbm25.blockmax.finalize/vcbm25.blockmax.wait",
    }
    q_tid, _ = e._prepare(*looked_up(e, queries))
    assert snap["counters"]["h2d_bytes"] == q_tid.nbytes + 4 * (idx.sealed.n_docs + 1)


@pytest.mark.parametrize("posting_mode", ["tf", "impact"])
def test_blockmax_build_spans(posting_mode):
    tracing.enable()
    blockmax_index(posting_mode)
    names = {path.split("/")[-1] for path in tracing.snapshot()["spans"]}
    assert {"vcbm25.build.ranges", "vcbm25.build.upload"} <= names
