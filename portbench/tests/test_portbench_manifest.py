"""BENCHMARK.json keeps to the benchmark's contract, and every file it
names is found by name."""

import json
import math
import os
import re

import pytest

from portbench import manifest

ROOT = os.path.dirname(manifest.HERE)
BENCH = manifest.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert os.path.isdir(os.path.join(ROOT, path)) and not path.endswith("_torch")


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), [n for n in names if not NAME.fullmatch(n)]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert all(UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    with open(os.path.join(ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert all(k in data for k in config["reduced"])
    assert {"assumed", "guarantees", "index", "corpus_model"} <= set(data)


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(workload):
    cell = manifest.load_cell(BENCH, workload["name"])
    assert cell.config["name"] == workload["config"]
    assert {"queries", "batch", "k", "in_flight", "warmup_batches"} <= set(cell.traffic)
    assert {"qps_cap", "keep_per_batch", "check_queries", "profile_batches", "limits"} <= set(cell.cell)
    assert set(cell.cell["limits"]) == {"score_rel_err", "rank_errors", "missing_results"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    module = manifest.load_module("metrics", metric["name"])
    assert callable(module.read)
    for w in metric.get("workloads", []):
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_roofline_modules_found():
    modules = manifest.roofline_modules()
    assert set(modules) == {"s1", "s2", "sp_stream", "s5"}
    for module in modules.values():
        assert module.KERNELS and callable(module.capture) and callable(module.cost)


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_reports_what_its_metrics_move(workload):
    cell = manifest.load_cell(BENCH, workload["name"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer and all(m["moves"] in reported for m in cell.per_layer)
