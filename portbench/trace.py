"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
short steady sub-window, read from its Chrome trace.

- the window: the profiler's active step (``ProfilerStep#...``);
- busy: the union of the device's kernel, copy and fill intervals in it;
- idle gaps: the rest, each named by the innermost host annotation
  (``portbench.*``, recorded around the benchmark's calls into the
  program) over its middle;
- a kernel's device time: its kernel rows, matched by name.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

__all__ = ["Profile", "read_profile"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0]
    return name[:120]


@dataclass
class Profile:
    t0: float  # microseconds, the trace's clock
    t1: float
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)  # (name, cat, ts, dur)
    host: List[Tuple[str, float, float]] = field(default_factory=list)  # annotations

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted(
            (max(ts, self.t0), min(ts + dur, self.t1))
            for _, _, ts, dur in self.device
            if ts + dur > self.t0 and ts < self.t1
        )
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, names: Iterable[str]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold one
        of ``names``."""
        names = tuple(names)
        rows = [d for n, c, _, d in self.device if c == "kernel" and any(x in n for x in names)]
        return sum(rows) * 1e-6, len(rows)

    def _label(self, t: float) -> str:
        best = None
        for name, ts, dur in self.host:
            if ts <= t <= ts + dur and (best is None or dur < best[1]):
                best = (name, dur)
        return best[0] if best else "outside the benchmark's calls"

    def breakdown(self) -> dict:
        ops = {}
        for name, _, _, dur in self.device:
            key = _short(name)
            ops[key] = ops.get(key, 0.0) + dur * 1e-6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps, last = [], self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > last:
                gaps.append((self._label((a + last) / 2.0), (a - last) * 1e-6))
            last = max(last, b)
        gaps.sort(key=lambda g: -g[1])
        return {
            "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]],
        }


def read_profile(prof, tmpdir=None) -> Profile:
    """The active step of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host, steps = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in _DEVICE_CATS:
            device.append((name, cat, ts, dur))
        elif name.startswith("ProfilerStep#"):
            steps.append((ts, ts + dur))
        elif name.startswith("portbench."):
            host.append((name, ts, dur))
    if steps:
        t0, t1 = steps[-1]
    elif device or host:
        t0 = min([d[2] for d in device] + [h[1] for h in host])
        t1 = max([d[2] + d[3] for d in device] + [h[1] + h[2] for h in host])
    else:
        t0 = t1 = 0.0
    return Profile(t0=t0, t1=t1, device=device, host=host)
