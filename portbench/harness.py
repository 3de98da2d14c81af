"""One run of one cell: set-up, the measured window, the comparison.

Set-up makes the corpus, the queries and any documents to insert on the
device from the seed, hands the postings to the program's bulk build,
warms the cell's own shapes up with a few batches and measures the
index's device bytes.  The window then drives the program's pipelined
public entry for ``--seconds``: one client in a closed loop with
``in_flight`` batches dispatched, each step making its batch's ``Query``
objects, applying its writes, calling ``Bm25Index.search_batch_async``
and then the ``finalize()`` of the oldest batch in flight.  Spans are
taken around every call into the program; with ``--trace 1``
``torch.profiler`` also covers ``profile_batches`` steps in the middle of
the window, with each kernel's call arguments captured there for its
roofline.  Once the window has closed and the program's state is freed,
the plain reference scores a sample of the window's queries, drawn from
the seed, and ``check.py`` compares.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import importlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import manifest
from .check import compare
from .corpus import CorpusModel, col_of, derive_seed, generator, make_corpus, make_postings, payload_of
from .queries import make_queries
from .reference.bm25 import Reference, gather, top_lists
from .roofline.peaks import bound_s
from .trace import read_profile
from .writes import Writes

__all__ = ["RunData", "run_cell", "word_keys"]

clock = time.perf_counter


def word_keys(vocab: int) -> np.ndarray:
    """The 16-byte key of every word id: the id big-endian in the first
    four bytes, the port's key for integer token ids."""
    kb = np.zeros((vocab, 16), dtype=np.uint8)
    kb[:, :4] = np.arange(vocab, dtype=">u4").view(np.uint8).reshape(-1, 4)
    return kb.reshape(-1).view("S16")


@dataclass
class RunData:
    """What a per-layer metric's reader reads."""

    cell: str
    spans: Dict[str, np.ndarray]  # seconds, outside the profiled steps
    counters: Dict[str, int]
    build_s: float
    profile: object = None  # trace.Profile, or None
    calls: List[dict] = field(default_factory=list)  # kernel, bytes, ops, bound_s
    kernels: Dict[str, tuple] = field(default_factory=dict)  # kernel -> KERNELS
    # Queries finalized in the window outside the profiled steps, and the
    # window's seconds less the profiled steps'.
    window: tuple = (0, 0.0)

    def kernel_share(self, kernels) -> Optional[float]:
        """100 x the calls' least time over their kernels' device time."""
        if self.profile is None:
            return None
        least = sum(c["bound_s"] for c in self.calls if c["kernel"] in kernels)
        names = tuple(n for k in kernels for n in self.kernels.get(k, ()))
        spent, _ = self.profile.kernel_s(names)
        if least <= 0 or spent <= 0:
            return None
        return 100.0 * least / spent


class _Spans:
    def __init__(self):
        self.skip = False
        self.data = collections.defaultdict(list)

    def add(self, name, t0, t1):
        if not self.skip:
            self.data[name].append(t1 - t0)


class _GcWatch:
    """The interpreter's garbage collections in the window, as spans (and,
    in the profiled steps, as ``portbench.gc`` annotations)."""

    def __init__(self, spans, note):
        self.spans, self.note = spans, note
        self.t0, self.ann = 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = clock()
            if self.note[0] is not contextlib.nullcontext:
                self.ann = self.note[0]("portbench.gc")
                self.ann.__enter__()
        else:
            if self.ann is not None:
                self.ann.__exit__(None, None, None)
                self.ann = None
            self.spans.add(f"gc{info['generation']}", self.t0, clock())


class _Capture:
    """Wraps the name each engine module calls for every kernel of
    ``roofline/`` and records the call's arguments while ``on``; the call
    itself is unchanged."""

    def __init__(self, modules, layout_of):
        self.modules = modules
        self.layout_of = layout_of
        self.on = False
        self.calls = []
        self._saved = []

    def install(self):
        for name, mod in self.modules.items():
            owner = importlib.import_module(mod.TARGET[0])
            original = getattr(owner, mod.TARGET[1])
            self._saved.append((owner, mod.TARGET[1], original))
            setattr(owner, mod.TARGET[1], self._wrap(name, mod, original))

    def _wrap(self, name, mod, original):
        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            if self.on:
                layout = self.layout_of(args[0]) if mod.USES_LAYOUT else None
                self.calls.append((name, mod, mod.capture(args, kwargs), layout))
            return out

        return wrapper

    def uninstall(self):
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    """Run ``cell``; returns (result dict, the comparison's lines)."""
    from vectorchord_bm25_tpu_torch.index.bm25index import Bm25Index
    from vectorchord_bm25_tpu_torch.index.sealed import build_sealed_segment_from_postings
    from vectorchord_bm25_tpu_torch.text.intern import Document, Query
    from vectorchord_bm25_tpu_torch.utils.options import IndexOptions

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix, cc = cell.config, cell.traffic, cell.cell
    batch, k, depth = int(mix["batch"]), int(mix["k"]), int(mix["in_flight"])
    warm = int(mix["warmup_batches"])
    model = CorpusModel.from_config(cfg)
    n = model.n_docs
    kernels = manifest.roofline_modules()

    # Inputs, from the seed, on the device.
    corpus = make_corpus(model, seed, dev)
    steps_cap = warm + math.ceil(float(cc["qps_cap"]) * seconds / batch) + 2
    n_queries = steps_cap * batch
    q_start, q_tid = make_queries(corpus, n_queries, mix["queries"], seed, dev)
    writes, extra = None, None
    if mix.get("writes"):
        writes = Writes.from_spec(mix["writes"], n, steps_cap, seed)
        ex = make_postings(model, writes.n_extra, generator(seed, "inserts", dev), dev)
        extra = (ex.start.cpu().numpy(), ex.tid.cpu().numpy(), ex.tf.cpu().numpy())
        del ex
    corpus.by_doc = corpus.df = None
    _sync(dev)
    keys = word_keys(model.vocab)

    def make_queries_of(step):
        a, b = step * batch, (step + 1) * batch
        lo = q_start[a]
        words = keys[q_tid[lo : q_start[b]]]
        return [Query(keys=x) for x in np.split(words, q_start[a + 1 : b] - lo)]

    def make_doc(j):
        s, e = extra[0][j], extra[0][j + 1]
        return Document(keys=keys[extra[1][s:e]], values=extra[2][s:e])

    # The program's build.
    spans = _Spans()
    counters = collections.Counter()
    idx = cfg["index"]
    options = IndexOptions(k1=float(idx["k1"]), b=float(idx["b"]))
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    t = clock()
    sealed = build_sealed_segment_from_postings(
        None, corpus.doc.copy(), corpus.tf.copy(), n,
        payloads=payload_of(np.arange(n)), options=options, presorted=True,
        token_ids=corpus.tid.copy(), vocab_keys=keys,
    )
    index = Bm25Index(
        sealed, hashlib.sha256(f"{seed}:index".encode()).digest(), options,
        engine=idx["engine"], engine_options=idx.get("engine_options") or None, device=dev,
    )
    index.engine()
    _sync(dev)
    build_s = clock() - t
    del sealed
    if writes is not None:
        for j in writes.preload_docs():
            index.insert(make_doc(j), int(payload_of(n + j)))

    pending = collections.deque()
    records = []  # (step, phase, t_dispatch, t_done, queries, lists)
    kept = {}
    keep_rng = np.random.default_rng(derive_seed(seed, "keep"))
    keep_rows = int(cc["keep_per_batch"])
    phase = ["warmup"]
    note = [contextlib.nullcontext]

    def dispatch(step):
        if (step + 1) * batch > n_queries:
            raise RuntimeError("the traffic ran out of queries; raise the cell's qps_cap")
        ann = note[0]
        t0 = clock()
        with ann("portbench.queries"):
            queries = make_queries_of(step)
        t1 = clock()
        if writes is not None:
            with ann("portbench.writes"):
                ins, dels = writes.step(step)
                for j in ins:
                    ti = clock()
                    with ann("portbench.insert"):
                        index.insert(make_doc(j), int(payload_of(n + j)))
                    spans.add("insert", ti, clock())
                index.bulkdelete_payloads(payload_of(dels))
        t2 = clock()
        with ann("portbench.dispatch"):
            fin = index.search_batch_async(queries, k)
        t3 = clock()
        spans.add("queries", t0, t1)
        spans.add("writes", t1, t2)
        spans.add("dispatch", t2, t3)
        stats = getattr(index.engine(), "last_ms_stats", None)
        if stats and "batch_queries" in stats and not spans.skip:
            counters["ms_batch_queries"] += int(stats["batch_queries"])
            counters["ms_routed_queries"] += int(stats["routed_queries"])
            counters["ms_fallback_queries"] += int(stats["fallback_queries"])
        pending.append((step, phase[0], t2, fin, len(queries)))

    def finalize_oldest():
        step, ph, t2, fin, nq = pending.popleft()
        t4 = clock()
        with note[0]("portbench.finalize"):
            res = fin()
        t5 = clock()
        spans.add("finalize", t4, t5)
        records.append((step, ph, t2, t5, nq, len(res)))
        if ph == "window":
            for r in keep_rng.choice(nq, size=min(keep_rows, nq), replace=False).tolist():
                kept[(step, r)] = (
                    (np.array([h[0] for h in res[r]], dtype=np.float64),
                     np.array([h[1] for h in res[r]], dtype=np.int64))
                    if r < len(res) else None
                )

    def run_step(step):
        with note[0]("portbench.step"):
            dispatch(step)
            if len(pending) >= depth:
                finalize_oldest()

    def drain():
        while pending:
            finalize_oldest()

    # Warm-up: the cell's own shapes, then the index's device bytes.
    spans.skip = True
    step = 0
    for _ in range(warm):
        run_step(step)
        step += 1
    drain()
    _sync(dev)
    index_mib = ((torch.cuda.memory_allocated(dev) if cuda else 0) - mem0) / float(1 << 20)
    gc.collect()
    gc.freeze()
    gc_watch = _GcWatch(spans, note)
    gc.callbacks.append(gc_watch)
    phase[0] = "window"
    spans.skip = False
    setup_s = clock() - t_process

    def profiled_steps(step):
        """``profile_batches`` steps under ``torch.profiler`` with the
        kernels' calls captured; returns (next step, profile, capture)."""
        drain()
        _sync(dev)
        t_prof = clock()
        capture = _Capture(kernels, _layout_finder(index))
        capture.install()
        spans.skip = True
        note[0] = torch.profiler.record_function
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
        )
        prof.start()
        # The warm-up step: the tracer drops kernels of a call that begins
        # as it starts.
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        prof.step()
        capture.on = True
        for _ in range(int(cc["profile_batches"])):
            run_step(step)
            step += 1
        drain()
        _sync(dev)
        capture.on = False
        prof.step()
        prof.stop()
        capture.uninstall()
        note[0] = contextlib.nullcontext
        spans.skip = False
        profiled.append((t_prof, clock()))
        return step, read_profile(prof), capture

    # The window.
    profile, capture = None, None
    profiled = []  # (start, end) of the profiled steps
    t_begin = clock()
    t_end = t_begin + seconds
    profile_at = t_begin + 0.4 * seconds if trace else math.inf
    while clock() < t_end:
        if clock() >= profile_at:
            profile_at = math.inf
            step, profile, capture = profiled_steps(step)
            continue
        run_step(step)
        step += 1
    drain()
    _sync(dev)
    gc.callbacks.remove(gc_watch)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    window = [r for r in records if r[1] == "window"]
    done = [r for r in window if r[3] <= t_end]
    lat = np.asarray([r[3] - r[2] for r in done], dtype=np.float64)
    end_to_end = {
        "qps": sum(r[4] for r in done) / seconds,
        "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat.size else None,
        "index_mib": index_mib,
        "setup_s": setup_s,
    }
    outside = [r for r in done if not any(a <= r[2] <= b for a, b in profiled)]
    window_s = seconds - sum(min(b, t_end) - a for a, b in profiled)
    calls = []
    if capture is not None:
        for name, mod, rec, layout in capture.calls:
            n_bytes, n_ops = mod.cost(rec, layout)
            calls.append({"kernel": name, "bytes": n_bytes, "ops": n_ops, "bound_s": bound_s(n_bytes, n_ops)})
    run = RunData(
        cell=cell.name,
        spans={key: np.asarray(v) for key, v in spans.data.items()},
        counters=dict(counters),
        build_s=build_s,
        profile=profile,
        calls=calls,
        kernels={name: mod.KERNELS for name, mod in kernels.items()},
        window=(sum(r[4] for r in outside), window_s),
    )

    # The program's state goes before the reference runs.
    del index, pending, capture
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = cc["limits"]
    readings = _judge(cell, seed, corpus, q_start, q_tid, writes, extra, kept, batch, k, limits, dev)
    readings.missing_results = sum(r[4] - min(r[5], r[4]) for r in window)
    values = readings.values()
    correct = all(values[name] <= limits[name] for name in limits) and readings.queries > 0
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {
            m["name"]: {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end
            if end_to_end.get(m["name"]) is not None
        }
    result = {
        "correct": bool(correct),
        "attempted": int(sum(r[4] for r in window)),
        "failed": int(readings.failed_queries + readings.missing_results),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if trace and profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["run"] = {
        "batches": len(done),
        "steps": step,
        "postings": int(corpus.tid.size),
        "sampled_queries": readings.queries,
        "build_s": build_s,
        "gc_s": {key[2:]: float(np.sum(v)) for key, v in run.spans.items() if key.startswith("gc")},
        "span_s": {key: float(np.sum(v)) for key, v in run.spans.items() if not key.startswith("gc")},
    }
    if profile is not None:
        result["run"]["kernels"] = {
            name: {
                "calls": sum(c["kernel"] == name for c in calls),
                "bound_s": sum(c["bound_s"] for c in calls if c["kernel"] == name),
                "device_s_launches": profile.kernel_s(mod.KERNELS),
            }
            for name, mod in kernels.items()
        }
    result["checks"] = checks
    return result, readings.worst


def _layout_finder(index):
    """words tensor -> the stream index of the engine that owns it (the
    sealed engine, or the growing segment's engine)."""

    def layout_of(words):
        for engine in (index.engine(), getattr(index.growing, "_dev_engine", None)):
            if engine is not None and getattr(engine, "dev_words", None) is words:
                return engine.stream
        raise LookupError("a kernel call on a stream no engine of the index owns")

    return layout_of


def make_reference(cell, corpus, extra, dev, dtype=torch.float64) -> Reference:
    """The plain reference over the run's own inputs."""
    idx = cell.config["index"]
    return Reference(
        corpus.tid, corpus.doc, corpus.tf, corpus.n_docs, corpus.model.vocab,
        float(idx["k1"]), float(idx["b"]), dev, dtype, extra,
    )


def answer_sample(ref, chosen, q_start, q_tid, batch, k, writes, answer):
    """The sampled queries ``chosen`` ((step, row) pairs), a block at a
    time: (got, want, want_of_got) for ``check.compare``, where ``got`` is
    what ``answer(part, words, visible, deleted)`` says for a block and
    ``want`` the float64 reference's top-k."""
    got_all, want_all, wog_all = [], [], []
    block = ref.block_rows()
    for b0 in range(0, len(chosen), block):
        part = chosen[b0 : b0 + block]
        qids = [s * batch + r for s, r in part]
        words = [q_tid[q_start[g] : q_start[g + 1]] for g in qids]
        visible = [writes.visible(s) for s, _ in part] if writes is not None else None
        deleted = [writes.deleted(s) for s, _ in part] if writes is not None else None
        got = answer(part, words, visible, deleted)
        acc = ref.sums(words, visible, deleted)
        want_all += top_lists(acc, k)
        wog_all += gather(acc, [np.asarray([c for _, c in g] if g else [], dtype=np.int64) for g in got])
        got_all += got
        del acc
    return got_all, want_all, wog_all


def _judge(cell, seed, corpus, q_start, q_tid, writes, extra, kept, batch, k, limits, dev):
    """The plain reference over a sample of the window's queries."""
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    keys = sorted(kept)
    take = min(int(cell.cell["check_queries"]), len(keys))
    chosen = [keys[i] for i in sorted(rng.choice(len(keys), size=take, replace=False).tolist())] if take else []

    def answer(part, words, visible, deleted):
        got = []
        for key in part:
            hits = kept[key]
            got.append(None if hits is None else list(zip(hits[0].tolist(), col_of(hits[1]).tolist())))
        return got

    ref = make_reference(cell, corpus, extra, dev)
    got, want, wog = answer_sample(ref, chosen, q_start, q_tid, batch, k, writes, answer)
    labels = [f"step {s} row {r}" for s, r in chosen]
    return compare(got, want, wog, float(limits["score_rel_err"]), labels)
