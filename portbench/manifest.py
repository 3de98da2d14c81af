"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``c``: ``configs/c.json``;
- a traffic mix ``m``: ``traffic/m.json`` (read by ``queries.py`` and
  ``writes.py``, the one general generator);
- a cell ``w``: ``cells/w.json`` (its query cap, its sample for the
  comparison and the comparison's limits);
- a per-layer metric ``x``: ``metrics/x.py``, whose ``read(run)`` returns
  the metric or None;
- a kernel ``k``: ``roofline/k.py`` (its call capture and its bytes and
  operations).
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

__all__ = ["HERE", "Cell", "load_benchmark", "load_cell", "load_module", "roofline_modules"]

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def roofline_modules() -> Dict[str, object]:
    """Every kernel of ``roofline/`` by its file name: the modules that
    define ``TARGET`` (helpers such as the table of peaks define none)."""
    out = {}
    for entry in sorted(os.listdir(os.path.join(HERE, "roofline"))):
        if entry.endswith(".py") and not entry.startswith("_"):
            module = load_module("roofline", entry[:-3])
            if hasattr(module, "TARGET"):
                out[entry[:-3]] = module
    return out


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    cell: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` with its files and the metrics it reports."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
    w = entries[workload]
    return Cell(
        name=workload,
        config=_json("configs", f"{w['config']}.json"),
        traffic=_json("traffic", f"{w['traffic']}.json"),
        cell=_json("cells", f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
