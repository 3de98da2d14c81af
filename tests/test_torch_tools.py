"""The port's operator modules on the CPU, against the reference's:

- ``utils/memparity.py``: ``memory_parity_report`` and
  ``reference_format_bytes`` equal the reference's on the same segment for
  the stream, Block-Max, exact (dense and compact) and hybrid engines;
- ``utils/profiling.py``: ``trace`` writes a Chrome trace that holds an
  ``annotate`` name; ``ConsoleProgress`` prints the reference's lines for
  the same calls on the same clock;
- ``tools/parity_diag.py``: ``diagnose`` counts what ``oracle_rank_parity``
  counts (0 on a real index), classifies a swap of two f64-tied docs as an
  "f32 boundary" and of two clearly apart as a "real gap", and its ``main``
  prints the reference tool's lines for the same index;
- ``tools/dryrun.py``: ``dryrun_multichip(8, device="cpu")`` passes and
  prints the reference's line (``MULTICHIP_r05.json``).

Tolerance: none; every comparison is exact.
"""

import glob
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index import sealed as ref_sealed  # noqa: E402
from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.search import blockmax as ref_blockmax  # noqa: E402
from vectorchord_bm25_tpu.search import exact as ref_exact  # noqa: E402
from vectorchord_bm25_tpu.search import hybrid as ref_hybrid  # noqa: E402
from vectorchord_bm25_tpu.search import stream as ref_stream  # noqa: E402
from vectorchord_bm25_tpu.utils import memparity as ref_memparity  # noqa: E402
from vectorchord_bm25_tpu.utils import profiling as ref_profiling  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.data.harness import oracle_rank_parity  # noqa: E402
from vectorchord_bm25_tpu_torch.index import sealed  # noqa: E402
from vectorchord_bm25_tpu_torch.search import blockmax, exact, hybrid, stream  # noqa: E402
from vectorchord_bm25_tpu_torch.tools import dryrun, parity_diag  # noqa: E402
from vectorchord_bm25_tpu_torch.utils import memparity, profiling  # noqa: E402

from test_sealed import make_docs  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENGINES = {
    "stream": (ref_stream.StreamEngine, stream.StreamEngine, {}),
    "blockmax": (ref_blockmax.BlockMaxEngine, blockmax.BlockMaxEngine, {}),
    "exact": (ref_exact.ExactEngine, exact.ExactEngine, {}),
    "exact-compact": (ref_exact.ExactEngine, exact.ExactEngine, {"compact": True}),
    "hybrid": (ref_hybrid.HybridEngine, hybrid.HybridEngine, {}),
}


@pytest.fixture(scope="module")
def segments():
    docs = make_docs(np.random.default_rng(21), 3000, vocab=60)
    payloads = np.arange(len(docs), dtype=np.int64) * 3 + 1
    port_docs = [Document(keys=d.keys, values=d.values) for d in docs]
    return (
        ref_sealed.build_sealed_segment(docs, payloads=payloads),
        sealed.build_sealed_segment(port_docs, payloads=payloads),
    )


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_memory_parity_equals_reference(segments, name):
    ref_seg, seg = segments
    ref_cls, cls, kw = ENGINES[name]
    want = ref_memparity.memory_parity_report(ref_cls(ref_seg, **kw), ref_seg)
    got = memparity.memory_parity_report(cls(seg, device="cpu", **kw), seg)
    assert got == want
    assert got["reference_bytes"] > 0 and got["ratio_vs_reference"] > 0
    assert memparity.reference_format_bytes(seg) == ref_memparity.reference_format_bytes(
        ref_seg
    )


def test_memory_parity_of_an_empty_segment():
    seg = sealed.build_sealed_segment([])
    want = ref_memparity.reference_format_bytes(ref_sealed.build_sealed_segment([]))
    assert memparity.reference_format_bytes(seg) == want
    assert want["total"] == 0 and want["bytes_per_posting"] == 0.0


def test_trace_holds_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.arange(4096, dtype=torch.float32)
    with profiling.trace(logdir, device="cpu"):
        with profiling.annotate("vcbm25-annotated-span"):
            y = (x * 2).sum()
    assert float(y) == float(x.sum() * 2)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(logdir)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "vcbm25-annotated-span" in names


def test_trace_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path), device="cuda"):
            pass
    assert not os.listdir(tmp_path)


def test_console_progress_prints_the_reference_lines(monkeypatch):
    calls = [
        ("records", 0, 100), ("records", 10, 100), ("records", 50, 100),
        ("records", 99, 100), ("records", 100, 100), ("sort", 0, 3),
        ("sort", 1, 3), ("sort", 3, 3), ("write", 5, 0), ("ingest", 2, 7),
    ]
    ticks = [0.0, 0.1, 0.3, 0.9, 1.2, 1.25, 1.3, 2.0, 2.1, 2.15, 3.0]

    def lines(module):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        out = io.StringIO()
        progress = module.ConsoleProgress(stream=out)
        for call in calls:
            progress(*call)
        return out.getvalue()

    want = lines(ref_profiling)
    assert lines(profiling) == want
    assert want.count("\n") == 7  # three records calls fall inside the interval


class Swapped:
    """An index whose ``search`` swaps ranks 0 and 1 of the given queries."""

    def __init__(self, index, swap):
        self.sealed = index.sealed
        self._index = index
        self._swap = {q.keys.tobytes() for q in swap}

    def search(self, query, k):
        hits = list(self._index.search(query, k=k))
        if query.keys.tobytes() in self._swap and len(hits) > 1:
            hits[0], hits[1] = hits[1], hits[0]
        return hits


def _diag_indexes():
    rng = np.random.default_rng(4)
    docs = [Document.from_int_ids(i) for i in ([7], [7], [8], [8, 9, 9, 9])]
    for _ in range(40):
        docs.append(Document.from_int_ids(rng.integers(0, 5, size=int(rng.integers(1, 9))).tolist()))
    payloads = np.arange(len(docs)) * 5 + 2
    port_index = Bm25Index.build(docs, payloads=payloads, device="cpu")
    from vectorchord_bm25_tpu.text.intern import Document as RefDocument

    ref_index = RefIndex.build(
        [RefDocument(keys=d.keys, values=d.values) for d in docs],
        payloads=payloads, seed=port_index.seed,
    )
    queries = [Query.from_int_ids(i) for i in ([7], [8], [1, 2], [0, 3, 4], [9])]
    return port_index, ref_index, queries


def test_diagnose_counts_as_oracle_rank_parity():
    index, _, queries = _diag_indexes()
    assert parity_diag.diagnose(index, queries) == []
    assert oracle_rank_parity(None, index, k=10, queries=queries) == 0
    swapped = Swapped(index, queries[:2])
    records = parity_diag.diagnose(swapped, queries)
    assert len(records) == oracle_rank_parity(None, swapped, k=10, queries=queries) == 2
    tie, gap = records
    assert [r["query"] for r in records] == [0, 1]
    assert tie["engine"] == [7, 2] and tie["f64"] == tie["tie_grouped"] == [2, 7]
    assert [d["class"] for d in tie["ranks"]] == ["f32 boundary"] * 2
    assert all(d["rel_gap"] < 4e-6 for d in tie["ranks"])
    assert gap["engine"] == [17, 12] and gap["f64"] == [12, 17]
    assert [d["class"] for d in gap["ranks"]] == ["real gap"] * 2
    assert all(d["rel_gap"] > 4e-6 for d in gap["ranks"])
    assert gap["ranks"][0]["engine_s64"] < gap["ranks"][0]["expected_s64"]


def test_parity_diag_main_prints_the_reference_lines(monkeypatch, capsys):
    port_index, ref_index, queries = _diag_indexes()
    spec = importlib.util.spec_from_file_location(
        "reference_parity_diag", os.path.join(REPO, "tools", "parity_diag.py")
    )
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)

    import vectorchord_bm25_tpu.data.harness as ref_harness
    import vectorchord_bm25_tpu.data.stream_synth as ref_synth
    import vectorchord_bm25_tpu.index.storage as ref_storage
    import vectorchord_bm25_tpu_torch.data.harness as harness
    import vectorchord_bm25_tpu_torch.data.stream_synth as synth
    import vectorchord_bm25_tpu_torch.index.storage as storage
    from vectorchord_bm25_tpu.text.intern import Query as RefQuery

    opened = []
    for h, s, st, index, qs in (
        (ref_harness, ref_synth, ref_storage, ref_index, [RefQuery(keys=q.keys) for q in queries]),
        (harness, synth, storage, port_index, queries),
    ):
        stub = Swapped(index, qs[:2])
        monkeypatch.setattr(s, "generate_streaming", lambda shape: shape)
        monkeypatch.setattr(
            st, "open_index", lambda path, stub=stub, **kw: opened.append((path, kw)) or stub
        )
        monkeypatch.setattr(h, "make_queries", lambda ds, index, qs=qs: list(qs))
    args = ["--cache", "cachedir", "--dataset", "synthetic:tiny", "--audit", "4"]
    monkeypatch.setattr(sys, "argv", ["parity_diag.py", *args])
    ref_tool.main()
    want = capsys.readouterr().out
    parity_diag.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "<- f32 boundary" in want and "<- REAL GAP" in want
    assert want.endswith("mismatches (same rule as the bench audit): 2/4\n")
    path = os.path.join("cachedir", "dsidx_tiny")
    assert opened == [(path, {}), (path, {"device": torch.device("cpu")})]


def test_dryrun_on_the_cpu(capsys):
    dryrun.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        want = json.load(f)["tail"]
    assert out == want
