"""The benchmark's Block-Max cell: its files found by name, the kernels'
bytes and operations counted by hand, and the capture of the round loop's
kernel calls on the CPU."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import harness, manifest  # noqa: E402
from portbench.roofline import b1_bounds, b1_merge, b1_select, p1_tf  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402
from vectorchord_bm25_tpu_torch.search import blockmax  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(manifest.HERE)
BENCH = manifest.load_benchmark(ROOT)
CELL = "msmarco-blockmax.top100"
MODULES = {"p1_tf": p1_tf, "b1_bounds": b1_bounds, "b1_select": b1_select, "b1_merge": b1_merge}
ACCEPTED = ["trec-covid.search", "msmarco.heavy", "trec-covid.ingest"]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_target_is_a_name_the_round_loop_calls(name):
    module = MODULES[name]
    owner, attr = module.TARGET
    assert owner == blockmax.__name__ and callable(getattr(blockmax, attr))
    assert attr in blockmax._blockmax_kernel.__code__.co_names
    assert module.USES_LAYOUT is False and module.KERNELS
    assert name in manifest.roofline_modules()


def test_p1_tf_by_hand():
    lens = torch.tensor([[[3, 0], [1, 2]]], dtype=torch.int32)  # Q=1, T=2, C=2
    args = [torch.zeros(8, dtype=torch.uint8)] + [None] * 6 + [lens]
    n_bytes, ops = p1_tf.cost(p1_tf.capture(args, {"rs": 128, "n_docs": 1000}), None)
    # 6 active lanes of tf, slot and fieldnorm; 4 starts and 4 lengths; a
    # [1, 2, 128] f32 output; s0 [1, 2], cand_r [1, 2], the s1 table.
    assert n_bytes == 6 * 3 + 8 * 4 + 4 * 2 * 128 + 4 * 2 + 4 * 2 + 1024
    assert ops == 4 * 6
    args[0] = torch.zeros(8, dtype=torch.int16)  # u16 term frequencies
    assert p1_tf.cost(p1_tf.capture(args, {"rs": 128}), None)[0] == n_bytes + 6


# A CSR over 4 terms (+ the null term 4 and its pad): 3, 0, 2, 5 groups.
TTS = torch.tensor([0, 3, 3, 5, 10, 10], dtype=torch.int32)
Q_TID = torch.tensor([[0, 2], [3, 4]], dtype=torch.int32)  # groups 5 and 5


def test_b1_bounds_by_hand():
    args = [TTS, None, None, Q_TID]
    n_bytes, ops = b1_bounds.cost(b1_bounds.capture(args, {"n_ranges": 16, "lmax": 8}), None)
    assert n_bytes == 12 * 4 + 8 * 10 + 4 * 2 * 16
    assert ops == 10 + 2 * 16


def test_b1_select_by_hand():
    # Query 0 has taken 8 ranges (C=4: active in rounds 0 and 1), query 1
    # none (inactive from round 0).
    ub = torch.zeros((2, 16), dtype=torch.float32)
    ub[0, [1, 3, 4, 6, 9, 10, 12, 15]] = float("-inf")
    flags = torch.zeros(8, dtype=torch.int32)
    kw = {"chunk": 4, "lmax": 8}

    def cost(r):
        args = [ub, torch.zeros((2, 10)), None, None, TTS, Q_TID]
        return b1_select.cost(b1_select.capture(args, dict(kw, flag=flags[r : r + 1])), None)

    base = 4 * 2 * 16 + 4 * 2 + 4 * 2 * 4 + 8 * 2 * 2 * 4 + 12 * 2 * 2
    for r in (0, 1):
        assert cost(r) == (base + 4 * 4 + 4 * 5, 2 * 16 + 2 * 4 * 4)  # one active query, 5 groups
    assert cost(2) == (base, 2 * 16)


def test_b1_merge_by_hand():
    acc = torch.zeros((2, 4, 128))
    args = [acc, None, None, None, torch.zeros((2, 100)), None]
    n_bytes, ops = b1_merge.cost(b1_merge.capture(args, {"n_docs": 1000}), None)
    assert n_bytes == 4 * 2 * 4 * 128 + 4 * 2 * 4 + 16 * 2 * 100 and ops == 0


def test_captured_round_loop_counts_what_ran():
    """The four modules wrapped as the traced run wraps them, on a CPU
    index that runs several rounds: one capture a call, and B1-select's
    active queries, read after the batch from its bound rows, are those
    whose row held a bound above the threshold when the round began."""
    rng = np.random.default_rng(3)
    docs = [Document.from_int_ids(rng.integers(0, 50, size=int(rng.integers(1, 40))).tolist()) for _ in range(900)]
    idx = Bm25Index.build(docs, engine="blockmax", engine_options={"posting_mode": "tf", "chunk": 1}, device="cpu")
    queries = [Query.from_int_ids(rng.integers(0, 50, size=3).tolist()) for _ in range(24)]
    idx.search_batch_async(queries, 10)()
    active_seen = []
    real_select = blockmax.round_select

    def select(ub_work, topk_s, *rest, **kw):
        active_seen.append(int((ub_work.amax(dim=1) > topk_s[:, -1].clamp_min(0.0)).sum()))
        return real_select(ub_work, topk_s, *rest, **kw)

    blockmax.round_select = select
    capture = harness._Capture(MODULES, None)
    try:
        capture.install()
        capture.on = True
        idx.search_batch_async(queries, 10)()
    finally:
        capture.uninstall()
        blockmax.round_select = real_select
    rounds = idx.engine().last_rounds
    by_kernel = {}
    for name, mod, rec, _ in capture.calls:
        by_kernel.setdefault(name, []).append(rec)
    assert rounds > 1 and len(active_seen) == rounds + 1
    assert [len(by_kernel[n]) for n in ("b1_bounds", "b1_select", "p1_tf", "b1_merge")] == [1, rounds + 1, rounds, rounds]
    t, c = by_kernel["b1_select"][0]["q_tid"].shape[1], 1
    lmax_ops = max(1, by_kernel["b1_select"][0]["lmax"].bit_length())
    for rec, want in zip(by_kernel["b1_select"], active_seen):
        _, ops = b1_select.cost(rec, None)
        q, r = rec["ub"].shape
        assert ops == q * r + want * t * c * lmax_ops
    assert active_seen[-1] == 0 and active_seen[0] > active_seen[-2] > 0


def test_manifest_loads_the_cell():
    cell = manifest.load_cell(BENCH, CELL)
    assert cell.config["index"]["engine"] == "blockmax"
    assert cell.config["index"]["engine_options"] == {"posting_mode": "tf"}
    assert (cell.traffic["k"], cell.traffic["batch"], cell.traffic["queries"]["mix"]) == (100, 512, "heavy")
    assert cell.cell["limits"] == {"score_rel_err": 1e-4, "rank_errors": 0, "missing_results": 0}
    reported = {m["name"] for m in cell.end_to_end}
    assert {"index_mib", "setup_s"} <= reported
    layers = {m["name"] for m in cell.per_layer}
    assert "build_s" in layers
    for m in cell.per_layer:
        assert m["moves"] in reported, m["name"]


def test_config_keeps_msmarcos_corpus():
    heavy = manifest.load_cell(BENCH, "msmarco.heavy").config
    mine = manifest.load_cell(BENCH, CELL).config
    for key in ("n_docs", "mean_len", "vocab", "n_topics", "corpus_model", "published", "reduced"):
        assert mine[key] == heavy[key], key
    assert mine["guarantees"] == heavy["guarantees"]
    assert mine["index"]["k1"] == heavy["index"]["k1"] and mine["index"]["b"] == heavy["index"]["b"]


def test_accepted_entries_unchanged_but_for_the_new_cell():
    """The new cell adds entries; an accepted metric either keeps its list
    of accepted cells or has none (then it reads in every cell)."""
    names = [w["name"] for w in BENCH["workloads"]]
    assert names[: len(ACCEPTED)] == ACCEPTED and names[len(ACCEPTED) :] == [CELL]
    build_s = next(m for m in BENCH["per_layer"] if m["name"] == "build_s")
    assert "workloads" not in build_s  # read in every cell, this one too
    # Neither timed metric bounds the cell (its runs' qps and p95 spread
    # over half their bound), so the four Block-Max readers, which move
    # them, are listed by no cell; the accepted lists stay as they were.
    cell = manifest.load_cell(BENCH, CELL)
    assert {m["name"] for m in cell.end_to_end} == {"index_mib", "setup_s"}
    for name, cells in (("qps", ["trec-covid.ingest"]), ("batch_p95_ms", ACCEPTED[::2])):
        assert next(m for m in BENCH["end_to_end"] if m["name"] == name)["workloads"] == cells
    mine = ["bm_rounds", "bm_loop_ms", "bm_flag_ms", "blockmax_roofline"]
    assert not {m["name"] for m in BENCH["per_layer"]} & set(mine)
    for name in mine:
        assert callable(manifest.load_module("metrics", name).read)
    assert {m["name"] for m in cell.per_layer} == {"build_s"}


def test_roofline_reader_reads_nothing_without_a_profile():
    reader = manifest.load_module("metrics", "blockmax_roofline")
    run = harness.RunData(cell=CELL, spans={}, counters={}, build_s=1.0)
    assert reader.read(run) is None
    run.calls = [{"kernel": "p1_tf", "bytes": 1, "ops": 1, "bound_s": 1e-9}]
    assert reader.read(run) is None
