"""Tracing / profiling / progress utilities (counterpart of
``utils/profiling.py``, on ``torch.profiler``).

The reference reports index-build progress to Postgres's progress view
(pgstat_progress_update_param) and relies on external profilers; here:

- `trace(logdir, device)` wraps a block in a ``torch.profiler`` trace,
  with the card's kernels when ``device`` is a CUDA device, and writes a
  Chrome trace (``*.pt.trace.json``) into ``logdir``;
- `annotate(name)` adds a named ``record_function`` range around host
  code, which the trace shows by that name;
- `ConsoleProgress` is a build-progress callback for the segment build's
  `progress=` hooks (phases: records / sort / write / ingest).
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from .device import as_device

__all__ = ["trace", "annotate", "ConsoleProgress"]


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir``.  A CUDA ``device`` adds the card's activity (and raises,
    through ``as_device``, where torch sees no card); ``"cpu"`` traces the
    host alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if as_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named annotation visible in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


class ConsoleProgress:
    """Progress callback printing phase transitions and throughput.

    Use as `build_sealed_segment(..., progress=ConsoleProgress())`.
    """

    def __init__(self, stream=None, min_interval: float = 0.5):
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self._last = 0.0
        self._phase = None
        self._t0 = time.perf_counter()

    def __call__(self, phase: str, done: int, total: int) -> None:
        now = time.perf_counter()
        if phase != self._phase:
            self._phase = phase
            self._last = 0.0
        if now - self._last < self.min_interval and done < total:
            return
        self._last = now
        pct = 100.0 * done / max(total, 1)
        print(
            f"[{now - self._t0:7.1f}s] {phase}: {done}/{total} ({pct:.0f}%)",
            file=self.stream,
        )
