"""The traced run's readers: spans and counters on the CPU, and the
device trace's arithmetic on a made-up trace."""

import time

import pytest

from portbench.trace import Profile, _short

from .tiny import run_tiny, tiny_cell


def test_traced_cpu_run_reports_spans_and_no_device_share():
    result, _ = run_tiny("trec-covid.ingest", trace=True)
    m = result["metrics"]
    assert {"dispatch_ms", "finalize_ms", "build_s", "insert_ms"} <= set(m)
    assert m["dispatch_ms"]["value"] > 0 and m["insert_ms"]["value"] > 0
    # No card: the readers of the device trace find nothing and say nothing.
    assert "dense_roofline" not in m and "device_idle_pct" not in m
    assert result["correct"]


def test_profile_arithmetic():
    p = Profile(
        t0=0.0,
        t1=100.0,
        device=[
            ("void bm25::tiles::dense_tiles_kernel<int>(Args)", "kernel", 10.0, 10.0),
            ("(anonymous namespace)::dense_topk_select_kernel(float const*)", "kernel", 15.0, 10.0),
            ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 60.0, 5.0),
            ("late", "kernel", 98.0, 10.0),
        ],
        host=[("portbench.step", 0.0, 100.0), ("portbench.finalize", 30.0, 40.0)],
    )
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx((15 + 5 + 2) * 1e-6)
    assert p.kernel_s(("dense_tiles_kernel", "dense_topk_select_kernel")) == (pytest.approx(20e-6), 2)
    b = p.breakdown()
    assert b["idle_gaps"][0] == ["portbench.finalize", pytest.approx(35e-6)]
    assert b["idle_gaps"][1][0] == "portbench.step"
    assert [name for name, _ in b["device_ops"]][:2] == ["bm25::tiles::dense_tiles_kernel<int>", "dense_topk_select_kernel"]
    assert _short("void f<a>(int)") == "f<a>"


def test_traced_run_reports_window_qps():
    result, _ = run_tiny("trec-covid.search", trace=True)
    m = result["metrics"]
    assert {"dispatch_ms", "finalize_ms", "build_s", "window_qps"} <= set(m)
    assert m["window_qps"]["unit"] == "queries/s" and m["window_qps"]["value"] > 0
    assert result["correct"]


def test_sparse_path_readers_read_the_counters(monkeypatch):
    """The MaxScore and sparse-kernel readers, which no cell lists while
    the sparse cell has no steady timed metric, still read a traced run."""
    from portbench import harness
    from vectorchord_bm25_tpu_torch.search.stream import StreamEngine

    monkeypatch.setattr(StreamEngine, "SPARSE_MIN_DOCS", 1024)
    monkeypatch.setattr(StreamEngine, "MS_ROUTE_MIN_WINDOWS", 1)
    cell = tiny_cell("msmarco.heavy")
    cell.per_layer = [{"name": n, "unit": "%"} for n in ("ms_routed_pct", "ms_fallback_pct", "sparse_roofline")]
    result, _ = harness.run_cell(cell, 2**31 + 78, 0.6, True, "cpu", time.perf_counter())
    m = result["metrics"]
    assert 0 < m["ms_routed_pct"]["value"] <= 100 and 0 <= m["ms_fallback_pct"]["value"] <= 100
    assert "sparse_roofline" not in m  # no card, no kernel time
    assert result["correct"]


@pytest.mark.parametrize("window, want", [((512, 2.0), 256.0), ((0, 2.0), None), ((512, 0.0), None)])
def test_window_qps_reader(window, want):
    from portbench import manifest
    from portbench.harness import RunData

    run = RunData(cell="c", spans={}, counters={}, build_s=1.0, window=window)
    assert manifest.load_module("metrics", "window_qps").read(run) == want
