"""Host-parallel, out-of-core index build.

The reference builds large indexes with Postgres parallel workers that
each heap-scan a corpus share, spill sorted (token, doc, tf) mapping
runs to disk, locally merge, and then k-way merge across workers with
doc-id offset rebasing before the single-threaded flush
(src/index/bm25/am/am_build.rs:353-746, crates/bm25/src/io.rs).

This module is that pipeline for the standalone framework, with the
reference's memory discipline:

- N worker processes tokenize + intern their corpus shard and spill
  sorted 24-byte mapping runs (key[16] | doc u32 | tf u32) of at most
  `run_budget` bytes each (the 64 MiB in-RAM buffer of io.rs:69-98) plus
  a records sidecar (doc lengths / payloads); the corpus can arrive as a
  picklable `source(lo, hi) -> list[str]` callable so the text itself
  never has to fit in RAM;
- runs are k-way merged with per-worker doc-id offsets through the
  native streaming C++ merger (O(fan-in) memory), cascaded 32 ways at a
  time like io.rs:199-242;
- the merged stream feeds the STREAMING flush
  (index/streamflush.py) — chunked two-pass construction, so peak RAM is
  O(run_budget + chunk) + the final segment arrays, never O(corpus
  records).

Spill format matches crates/bm25/src/segment.rs's Mapping ordering
((key, doc) lexicographic), so runs produced here are mergeable by the
same machinery regardless of which worker wrote them.
"""

from __future__ import annotations

import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..index.sealed import SealedSegment
from ..index.streamflush import REC_DTYPE, build_sealed_segment_streaming
from ..native import loader
from ..utils.options import IndexOptions

__all__ = ["build_out_of_core"]

_REC_DTYPE = REC_DTYPE
MERGE_FAN_IN = 32  # cascade width (io.rs:199-242)
SCAN_CHUNK = 4096  # docs pulled from a text source at a time


class _RunSpiller:
    """Accumulates postings and spills (key, doc)-sorted runs of at most
    `budget` bytes (the reference's 64 MiB MappingsWriter buffer)."""

    def __init__(self, workdir: str, worker: int, budget: int):
        self.workdir = workdir
        self.worker = worker
        self.budget = max(budget, 24 * 1024)
        self.paths: List[str] = []
        self._keys: List[np.ndarray] = []
        self._docs: List[np.ndarray] = []
        self._tfs: List[np.ndarray] = []
        self._bytes = 0

    def push(self, keys: np.ndarray, docs: np.ndarray, tfs: np.ndarray):
        if keys.size == 0:
            return
        self._keys.append(keys)
        self._docs.append(docs)
        self._tfs.append(tfs)
        self._bytes += 24 * keys.size
        if self._bytes >= self.budget:
            self.flush()

    def flush(self):
        if not self._keys:
            return
        keys = np.concatenate(self._keys)
        docs = np.concatenate(self._docs)
        tfs = np.concatenate(self._tfs)
        self._keys, self._docs, self._tfs = [], [], []
        self._bytes = 0
        # Sort by (key, doc): integer lexsort on byteswapped u64 columns.
        k2 = np.ascontiguousarray(keys).view(np.uint64).reshape(-1, 2)
        if sys.byteorder == "little":
            hi, lo = k2[:, 0].byteswap(), k2[:, 1].byteswap()
        else:
            hi, lo = k2[:, 0], k2[:, 1]
        order = np.lexsort((docs, lo, hi))
        rec = np.zeros(keys.size, dtype=_REC_DTYPE)
        rec["key"] = keys[order]
        rec["doc"] = docs[order]
        rec["tf"] = tfs[order]
        path = os.path.join(
            self.workdir,
            f"mappings.{self.worker:03d}.{len(self.paths):04d}",
        )
        rec.tofile(path)
        self.paths.append(path)


def _tokenize_shard(args) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Worker: tokenize + intern a shard, spilling bounded sorted runs.

    Returns (run_paths, doc_lengths, payloads) for the shard.
    """
    (texts, source, lo_hi, payloads, seed, tokenizer_name, workdir,
     worker, run_budget) = args
    from ..text.corpus import document_from_counts
    from ..text.tokenizer import tsvector

    tokenizer = tsvector if tokenizer_name == "tsvector" else None
    if tokenizer is None:
        raise ValueError(f"unknown tokenizer {tokenizer_name!r}")

    lo, hi = lo_hi
    n = hi - lo
    spiller = _RunSpiller(workdir, worker, run_budget)
    lengths = np.zeros(n, dtype=np.int64)
    done = 0
    while done < n:
        stop = min(done + SCAN_CHUNK, n)
        chunk = (
            source(lo + done, lo + stop)
            if source is not None
            else texts[done:stop]
        )
        for j, text in enumerate(chunk):
            doc = document_from_counts(seed, tokenizer(text))
            i = done + j
            lengths[i] = doc.length()
            if len(doc):
                spiller.push(
                    doc.keys,
                    np.full(len(doc), i, dtype=np.uint32),
                    doc.values.astype(np.uint32),
                )
        done = stop
    spiller.flush()
    return spiller.paths, lengths, np.asarray(payloads, dtype=np.int64)


def _merge_runs(
    run_paths: Sequence[str],
    doc_offsets: Sequence[int],
    out_path: str,
    workdir: str,
) -> None:
    """Cascaded k-way merge, MERGE_FAN_IN runs at a time (io.rs:199-242);
    every pass streams through the native merger (O(fan-in) memory)."""
    runs = list(zip(list(run_paths), list(doc_offsets)))
    level = 0
    while len(runs) > MERGE_FAN_IN:
        nxt = []
        for gi in range(0, len(runs), MERGE_FAN_IN):
            group = runs[gi : gi + MERGE_FAN_IN]
            out = os.path.join(workdir, f"cascade.{level}.{gi:04d}")
            _merge_group(group, out)
            nxt.append((out, 0))  # offsets already applied
            for path, _ in group:
                if path != out:
                    os.unlink(path)
        runs = nxt
        level += 1
    _merge_group(runs, out_path)


def _merge_group(group, out_path: str) -> None:
    paths = [g[0] for g in group]
    offsets = [int(g[1]) for g in group]
    if loader.merge_mappings(paths, offsets, out_path):
        return
    # numpy fallback: concatenate with offsets, sort.
    parts = []
    for path, off in zip(paths, offsets):
        rec = np.fromfile(path, dtype=_REC_DTYPE)
        rec["doc"] = rec["doc"] + np.uint32(off)
        parts.append(rec)
    merged = np.concatenate(parts) if parts else np.zeros(0, _REC_DTYPE)
    merged = merged[np.lexsort((merged["doc"], merged["key"]))]
    merged.tofile(out_path)


def build_out_of_core(
    texts: Union[Sequence[str], Callable[[int, int], Sequence[str]]],
    seed: bytes,
    payloads: Optional[Sequence[int]] = None,
    options: Optional[IndexOptions] = None,
    n_workers: int = 4,
    spill_dir: Optional[str] = None,
    progress=None,
    n_docs: Optional[int] = None,
    run_budget: int = 64 << 20,
    flush_chunk: int = 4_000_000,
) -> SealedSegment:
    """Multi-process corpus build through disk-spilled sorted runs with
    bounded memory end to end.

    texts: a sequence of strings, or a picklable callable
    `source(lo, hi) -> list[str]` (pass n_docs) so the corpus streams
    from disk/generator instead of living in RAM.
    run_budget: max bytes of postings a worker buffers before spilling a
    sorted run (io.rs's 64 MiB).
    flush_chunk: postings per window in the streaming flush.
    """
    options = options or IndexOptions()
    source = texts if callable(texts) else None
    if source is not None:
        if n_docs is None:
            raise ValueError("n_docs is required with a callable source")
        n = int(n_docs)
    else:
        n = len(texts)
    if payloads is None:
        payloads = np.arange(n, dtype=np.int64)
    payloads = np.asarray(payloads, dtype=np.int64)

    tmp_ctx = (
        tempfile.TemporaryDirectory() if spill_dir is None else None
    )
    workdir = tmp_ctx.name if tmp_ctx else spill_dir
    try:
        bounds = np.linspace(0, n, n_workers + 1).astype(np.int64)
        jobs = []
        for w in range(n_workers):
            lo, hi = int(bounds[w]), int(bounds[w + 1])
            jobs.append(
                (
                    None if source is not None else list(texts[lo:hi]),
                    source,
                    (lo, hi),
                    payloads[lo:hi],
                    seed,
                    "tsvector",
                    workdir,
                    w,
                    run_budget,
                )
            )

        if n_workers == 1:
            results = [_tokenize_shard(jobs[0])]
        else:
            # Spawn (not fork): the parent may hold a CUDA context and live
            # torch threads, and forking a multithreaded process can
            # deadlock.  The workers import no torch.
            import multiprocessing

            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(
                max_workers=n_workers, mp_context=ctx
            ) as pool:
                results = list(pool.map(_tokenize_shard, jobs))
        if progress is not None:
            progress("scan", n, n)

        # Doc-id offset rebasing: exclusive scan of shard sizes
        # (io.rs:244-282); every run of worker w rebases by w's offset.
        shard_sizes = [len(r[1]) for r in results]
        offsets = np.cumsum([0] + shard_sizes)[:-1]
        all_lengths = np.concatenate([r[1] for r in results])
        all_payloads = np.concatenate([r[2] for r in results])
        del all_lengths  # lengths are re-derived by the streaming flush

        run_paths, run_offsets = [], []
        for w, r in enumerate(results):
            for path in r[0]:
                run_paths.append(path)
                run_offsets.append(int(offsets[w]))

        merged_path = os.path.join(workdir, "merged")
        if run_paths:
            _merge_runs(run_paths, run_offsets, merged_path, workdir)
        else:
            open(merged_path, "wb").close()
        if progress is not None:
            progress("merge", n, n)

        return build_sealed_segment_streaming(
            merged_path,
            n,
            payloads=all_payloads,
            options=options,
            chunk_postings=flush_chunk,
            progress=progress,
        )
    finally:
        if tmp_ctx:
            tmp_ctx.cleanup()
