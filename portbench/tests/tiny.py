"""Cells of ``BENCHMARK.json`` cut to a size a CPU test can hold."""

from __future__ import annotations

import copy
import os
import time

from portbench import harness, manifest

ROOT = os.path.dirname(manifest.HERE)
WORKLOADS = [w["name"] for w in manifest.load_benchmark(ROOT)["workloads"]]


def tiny_cell(name: str, batch: int = 64, check_queries: int = 96, writes=None) -> manifest.Cell:
    cell = manifest.load_cell(manifest.load_benchmark(ROOT), name)
    cfg = copy.deepcopy(cell.config)
    if cfg["name"] == "trec-covid":
        cfg.update(n_docs=3000, vocab=2000, n_topics=8)
        cfg["corpus_model"]["shared_vocab"] = 400
    else:
        cfg.update(n_docs=4000, vocab=4096, n_topics=64)
        cfg["corpus_model"]["shared_vocab"] = 1024
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch)
    if cell.traffic.get("writes"):
        small = {"preload_docs": 200, "inserts_per_step": 4, "deletes_per_step": 2, **(writes or {})}
        cell.traffic["writes"] = dict(cell.traffic["writes"], **small)
    cell.cell = dict(cell.cell, qps_cap=60000, check_queries=check_queries, profile_batches=2)
    return cell


def run_tiny(name: str, seed: int = 2**31 + 77, seconds: float = 0.6, trace: bool = False, **kw):
    """``harness.run_cell`` on the CPU: the run without its look for a card."""
    return harness.run_cell(tiny_cell(name, **kw), seed, seconds, trace, "cpu", time.perf_counter())
