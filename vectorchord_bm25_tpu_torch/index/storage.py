"""Index persistence: durable checkpoints + write-ahead mutation log (the
port's copy of the single-index half of the reference's
``index/storage.py``; the on-disk format is the reference's, byte for byte,
so a checkpoint written by either package opens in the other).

The reference delegates durability to PostgreSQL WAL — every page write
goes through GenericXLog and is aborted on panic
(src/index/storage.rs:227-238).  The standalone framework gets the same
guarantees from a checkpoint/WAL pair:

    <dir>/CURRENT        one-line pointer to the live generation dir,
                         swapped with atomic rename (crash mid-save
                         leaves the previous good checkpoint intact)
    <dir>/gen-NNNNNN/    a checkpoint generation:
        meta.json        options, seed, stats, format version
        sealed.npz       all sealed-segment arrays (bit-packed blocks)
        growing.jsonl    growing-segment docs at checkpoint time
        deleted.npy      sealed delete bitmap at checkpoint time
    <dir>/wal.log        append-only JSON-lines log of every acknowledged
                         mutation since the checkpoint in CURRENT; each
                         append is flushed + fsynced before the mutation
                         is acknowledged; replayed on load (a torn final
                         line — crash mid-append — is ignored, since that
                         op was never acknowledged)

The format carries a magic + version and refuses to load mismatched
versions with a "rebuild the index" error, mirroring the reference's
on-disk versioning (tuples.rs:104-108).
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

import numpy as np

from ..native import loader
from ..ops.bitpack import pack_u32_np, unpack_u32_np
from ..text.intern import WIDTH, Document
from ..utils.options import IndexOptions, SearchOptions
from .bm25index import Bm25Index
from .sealed import BLOCK as BLOCK_SIZE, SealedSegment

MAGIC = "vcbm25-tpu"
VERSION = 1

__all__ = [
    "save_index",
    "load_index",
    "open_index",
    "save_segment",
    "load_segment",
    "save_sharded_index",
    "load_sharded_index",
    "open_sharded_index",
    "Wal",
]


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """Write a file so a crash leaves either the old or the new content."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class Wal:
    """Append-only mutation log (the GenericXLog analog).

    Records are JSON lines; `append` fsyncs before returning so an
    acknowledged mutation survives a crash.  Replay tolerates a torn
    final line (crash mid-append = unacknowledged op).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def append(self, record: dict) -> None:
        self._f.write(json.dumps(record).encode() + b"\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def reset(self) -> None:
        """Truncate after a successful checkpoint (atomically)."""
        self.close()
        _atomic_write(self.path, b"")
        self._f = open(self.path, "ab")

    @staticmethod
    def replay(path: str, index: Bm25Index) -> int:
        """Apply logged mutations to a freshly loaded checkpoint."""
        return _replay_wal(path, index, "_engine_deleted_dirty")


def _replay_wal(path: str, index, dirty_attr: str) -> int:
    """Apply logged mutations to a loaded index; both the single-chip and
    sharded facades share the record format and the growing/deleted/
    maintain surfaces (only the deleted-dirty flag name differs)."""
    applied = 0
    if not os.path.exists(path):
        return applied
    with open(path, "rb") as f:
        for line in f:
            if not line.endswith(b"\n"):
                break  # torn tail from a crash mid-append
            try:
                rec = json.loads(line)
            except ValueError:
                break
            op = rec.get("op")
            if op == "insert":
                keys = np.frombuffer(
                    base64.b64decode(rec["keys"]), dtype=f"S{WIDTH}"
                )
                doc = Document(
                    keys=keys.copy(),
                    values=np.asarray(rec["values"], dtype=np.uint32),
                )
                index.growing.insert(doc, int(rec["payload"]))
            elif op == "delete":
                sealed = np.asarray(rec["sealed"], dtype=np.int64)
                if sealed.size:
                    index.deleted[sealed] = True
                    setattr(index, dirty_attr, True)
                for slot in rec["growing"]:
                    index.growing.deleted[slot] = True
            elif op == "maintain":
                index._maintain_locked()
            else:  # unknown op from a future version
                raise ValueError(f"unknown WAL op {op!r}; rebuild the index")
            applied += 1
    return applied


def _truncate_wal(index, directory: str) -> None:
    """Empty the WAL after a committed checkpoint (it only holds
    post-checkpoint mutations)."""
    wal = getattr(index, "_wal", None)
    if wal is not None and os.path.dirname(wal.path) == directory:
        wal.reset()
    else:
        wal_path = os.path.join(directory, "wal.log")
        if os.path.exists(wal_path):
            _atomic_write(wal_path, b"")

_SEGMENT_FIELDS = [
    "doc_fieldnorm",
    "doc_payload",
    "token_keys",
    "token_df",
    "token_wand_fn",
    "token_wand_tf",
    "token_block_start",
    "block_min_doc",
    "block_max_doc",
    "block_n",
    "block_wand_fn",
    "block_wand_tf",
    "block_docids",
    "block_tfs",
]


def _bitpack_full(vals: np.ndarray, bases=None):
    """Bit-pack full 128-blocks (native, numpy fallback)."""
    packed = loader.compress_blocks(vals, bases)
    if packed is not None:
        return packed
    b = vals.shape[0]
    widths = np.zeros(b, dtype=np.uint32)
    chunks = []
    offsets = np.zeros(b + 1, dtype=np.int64)
    for i in range(b):
        if bases is not None:
            row = np.diff(
                np.concatenate([[bases[i]], vals[i]]).astype(np.uint64)
            ).astype(np.uint32)
        else:
            row = vals[i]
        w = int(row.max()).bit_length() if row.size and row.max() else 0
        widths[i] = w
        c = pack_u32_np(row, w).view(np.uint8)
        chunks.append(c)
        offsets[i + 1] = offsets[i] + c.nbytes
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return data, widths, offsets


def _bitunpack_full(packed, bits, offsets, bases=None):
    vals = loader.decompress_blocks(packed, bits, offsets, bases)
    if vals is not None:
        return vals
    b = np.asarray(bits).size
    vals = np.zeros((b, 128), dtype=np.uint32)
    packed = np.asarray(packed, dtype=np.uint8)
    for i in range(b):
        w = int(bits[i])
        raw = packed[offsets[i] : offsets[i + 1]].tobytes()
        raw = raw.ljust(((128 * w + 31) // 32) * 4, b"\x00")
        row = unpack_u32_np(np.frombuffer(raw, dtype=np.uint32), w, 128)
        if bases is not None:
            row = (bases[i] + np.cumsum(row.astype(np.uint64))).astype(
                np.uint32
            )
        vals[i] = row
    return vals


def _bytepack_partial(vals: np.ndarray, ns: np.ndarray, bases=None):
    """Byte-pack partial blocks — only the first ns[i] live entries
    (the reference's partial-block policy, compression.rs:52-62)."""
    packed = loader.bytepack_blocks(vals, ns, bases)
    if packed is not None:
        return packed
    b = vals.shape[0]
    widths = np.zeros(b, dtype=np.uint32)
    chunks = []
    offsets = np.zeros(b + 1, dtype=np.int64)
    for i in range(b):
        n = int(ns[i])
        if bases is not None:
            row = np.diff(
                np.concatenate([[bases[i]], vals[i, :n]]).astype(np.uint64)
            ).astype(np.uint32)
        else:
            row = vals[i, :n]
        top = int(row.max()) if n else 0
        w = (top.bit_length() + 7) // 8
        widths[i] = w
        c = (
            row.astype("<u4").view(np.uint8).reshape(n, 4)[:, :w].ravel()
            if w
            else np.zeros(0, np.uint8)
        )
        chunks.append(c)
        offsets[i + 1] = offsets[i] + c.nbytes
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return data, widths, offsets


def _byteunpack_partial(packed, widths, offsets, ns, bases=None, fill=0):
    vals = loader.byteunpack_blocks(packed, widths, offsets, ns, bases, fill)
    if vals is not None:
        return vals
    b = np.asarray(widths).size
    vals = np.full((b, 128), fill, dtype=np.uint32)
    packed = np.asarray(packed, dtype=np.uint8)
    for i in range(b):
        n, w = int(ns[i]), int(widths[i])
        if n == 0:
            continue
        if w == 0:
            row = np.zeros(n, dtype=np.uint32)
        else:
            raw = packed[offsets[i] : offsets[i + 1]].reshape(n, w)
            full = np.zeros((n, 4), dtype=np.uint8)
            full[:, :w] = raw
            row = full.view("<u4").ravel()
        if bases is not None:
            row = (bases[i] + np.cumsum(row.astype(np.uint64))).astype(
                np.uint32
            )
        vals[i, :n] = row
    return vals


def save_segment(seg: SealedSegment, path: str, compress: bool = True) -> None:
    """Write a sealed segment.  With compress=True the [B, 128] block
    arrays are stored with the reference's codec policy
    (compression.rs:36-136): full 128-blocks are bit-packed (doc ids
    delta-coded from the block minimum, term frequencies plain), partial
    blocks are byte-packed over only their live entries (no padding on
    disk)."""
    arrays = {
        name: getattr(seg, name)
        for name in _SEGMENT_FIELDS
        if name not in ("block_docids", "block_tfs")
    }
    b = seg.n_blocks
    if compress and b:
        full = seg.block_n == BLOCK_SIZE
        part = ~full
        bases = seg.block_min_doc.astype(np.uint32)
        docids = seg.block_docids.astype(np.uint32)
        tfs = seg.block_tfs.astype(np.uint32)
        for prefix, data, widths, offsets in (
            ("fd", *_bitpack_full(docids[full], bases[full])),
            ("ft", *_bitpack_full(tfs[full])),
            (
                "pd",
                *_bytepack_partial(
                    docids[part], seg.block_n[part], bases[part]
                ),
            ),
            ("pt", *_bytepack_partial(tfs[part], seg.block_n[part])),
        ):
            arrays[f"{prefix}_bytes"] = data
            arrays[f"{prefix}_widths"] = widths
            arrays[f"{prefix}_offsets"] = offsets
    else:
        arrays["block_docids"] = seg.block_docids
        arrays["block_tfs"] = seg.block_tfs
    np.savez_compressed(path, **arrays)


def load_segment(path: str, options: IndexOptions, n_docs: int, sum_dl: int) -> SealedSegment:
    with np.load(path) as data:
        arrays = {
            name: data[name]
            for name in _SEGMENT_FIELDS
            if name in data.files
        }
        if "fd_bytes" in data.files:
            # Full/partial codec split (the reference policy).
            block_n = arrays["block_n"]
            b = block_n.size
            full = block_n == BLOCK_SIZE
            part = ~full
            bases = arrays["block_min_doc"].astype(np.uint32)
            docids = np.full((b, 128), n_docs, dtype=np.uint32)
            tfs = np.zeros((b, 128), dtype=np.uint32)
            docids[full] = _bitunpack_full(
                data["fd_bytes"], data["fd_widths"], data["fd_offsets"],
                bases[full],
            )
            tfs[full] = _bitunpack_full(
                data["ft_bytes"], data["ft_widths"], data["ft_offsets"]
            )
            docids[part] = _byteunpack_partial(
                data["pd_bytes"], data["pd_widths"], data["pd_offsets"],
                block_n[part], bases[part], fill=n_docs,
            )
            tfs[part] = _byteunpack_partial(
                data["pt_bytes"], data["pt_widths"], data["pt_offsets"],
                block_n[part],
            )
            arrays["block_docids"] = docids.astype(np.int32)
            arrays["block_tfs"] = tfs.astype(np.int32)
        elif "cd_bytes" in data.files:
            # Round-1 layout: every block bit-packed (padding included).
            bases = arrays["block_min_doc"].astype(np.uint32)
            docids = _bitunpack_full(
                data["cd_bytes"], data["cd_bits"], data["cd_offsets"], bases
            )
            tfs = _bitunpack_full(
                data["ct_bytes"], data["ct_bits"], data["ct_offsets"]
            )
            arrays["block_docids"] = docids.astype(np.int32)
            arrays["block_tfs"] = tfs.astype(np.int32)
    return SealedSegment(options=options, n_docs=n_docs, sum_dl=sum_dl, **arrays)


def _write_checkpoint_files(index: Bm25Index, gen_dir: str) -> None:
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "seed": base64.b64encode(index.seed).decode(),
        "options": {"k1": index.options.k1, "b": index.options.b},
        "search_options": {
            "limit": index.search_options.limit,
            "prefilter": index.search_options.prefilter,
        },
        "engine": index.engine_kind,
        "engine_options": index.engine_options,
        "n_docs": index.sealed.n_docs,
        "sum_dl": index.sealed.sum_dl,
    }
    with open(os.path.join(gen_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    save_segment(index.sealed, os.path.join(gen_dir, "sealed.npz"))
    np.save(os.path.join(gen_dir, "deleted.npy"), index.deleted)
    # Growing segment: replay log of (payload, keys, values).
    _write_growing_jsonl(index.growing, os.path.join(gen_dir, "growing.jsonl"))
    _fsync_dir(gen_dir)


def save_index(index: Bm25Index, directory: str) -> None:
    """Atomic checkpoint: write a fresh generation dir, fsync everything,
    swap the CURRENT pointer with an atomic rename, truncate the WAL, and
    only then garbage-collect older generations.  A crash at any point
    leaves a loadable index (the previous generation + its WAL)."""
    with index._rw.read(), index._mutex:
        _save_index_locked(index, directory)


def _commit_generation(directory: str, write_files) -> None:
    """Write a fresh generation dir via `write_files(gen_dir)`, commit it
    with the atomic CURRENT pointer swap, and GC superseded generations."""
    os.makedirs(directory, exist_ok=True)
    current_path = os.path.join(directory, "CURRENT")
    prev_gen = None
    if os.path.exists(current_path):
        with open(current_path) as f:
            prev_gen = f.read().strip() or None
    n = 1
    if prev_gen and prev_gen.startswith("gen-"):
        n = int(prev_gen[4:]) + 1
    gen = f"gen-{n:06d}"
    gen_dir = os.path.join(directory, gen)
    os.makedirs(gen_dir, exist_ok=True)
    write_files(gen_dir)
    # Point of no return: the pointer swap commits the new generation.
    _atomic_write(current_path, gen.encode())
    # GC superseded generations (best effort; stale dirs are harmless).
    import shutil

    for name in os.listdir(directory):
        if name.startswith("gen-") and name != gen:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _save_index_locked(index: Bm25Index, directory: str) -> None:
    _commit_generation(
        directory, lambda gen_dir: _write_checkpoint_files(index, gen_dir)
    )
    _truncate_wal(index, directory)


def load_index(directory: str, device="cuda") -> Bm25Index:
    """Load the committed checkpoint and replay the WAL; the index serves
    on ``device``.  Also reads the round-1 flat layout (meta.json at the
    top level, no CURRENT)."""
    current_path = os.path.join(directory, "CURRENT")
    if os.path.exists(current_path):
        with open(current_path) as f:
            base = os.path.join(directory, f.read().strip())
    else:
        base = directory
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC or meta.get("version") != VERSION:
        raise ValueError(
            f"on-disk index format mismatch (found "
            f"{meta.get('magic')}/{meta.get('version')}, expected "
            f"{MAGIC}/{VERSION}); rebuild the index"
        )
    options = IndexOptions(**meta["options"])
    search_options = SearchOptions(**meta["search_options"])
    seed = base64.b64decode(meta["seed"])
    sealed = load_segment(
        os.path.join(base, "sealed.npz"),
        options,
        meta["n_docs"],
        meta["sum_dl"],
    )
    index = Bm25Index(
        sealed, seed, options, search_options,
        engine=meta.get("engine", "blockmax"),
        engine_options=meta.get("engine_options") or None,
        device=device,
    )
    index.deleted = np.load(os.path.join(base, "deleted.npy"))

    def mark(slot):
        index.growing.deleted[slot] = True

    _replay_growing_jsonl(
        os.path.join(base, "growing.jsonl"), index.growing.insert, mark
    )
    Wal.replay(os.path.join(directory, "wal.log"), index)
    return index


def open_index(directory: str, device="cuda") -> Bm25Index:
    """Load an index onto ``device`` and attach its WAL so subsequent
    mutations are durable without a full checkpoint (the
    aminsert/ambulkdelete path)."""
    index = load_index(directory, device=device)
    index.attach_wal(Wal(os.path.join(directory, "wal.log")))
    return index


# ----------------------------------------------------------------------
# The growing segment's checkpoint file (shared by both index kinds).
# ----------------------------------------------------------------------
def _write_growing_jsonl(growing, path: str) -> None:
    with open(path, "w") as f:
        for i, doc in enumerate(growing.documents):
            rec = {
                "payload": growing.payloads[i],
                "deleted": growing.deleted[i],
                "keys": base64.b64encode(doc.keys.tobytes()).decode(),
                "values": doc.values.tolist(),
            }
            f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _replay_growing_jsonl(path: str, insert, mark_deleted) -> None:
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            keys = np.frombuffer(
                base64.b64decode(rec["keys"]), dtype=f"S{WIDTH}"
            )
            doc = Document(
                keys=keys.copy(),
                values=np.asarray(rec["values"], dtype=np.uint32),
            )
            slot = insert(doc, rec["payload"])
            if rec.get("deleted"):
                mark_deleted(slot)


# ----------------------------------------------------------------------
# Sharded-index persistence (same generation/CURRENT commit protocol).
# ----------------------------------------------------------------------
def save_sharded_index(index, directory: str) -> None:
    """Durable checkpoint of a ShardedIndex: one sealed-segment file per
    shard (reference codec policy), global meta, delete bitmap, and the
    growing segment — committed atomically via the CURRENT pointer."""
    with index._rw.read(), index._mutex:

        def write_files(gen_dir: str) -> None:
            meta = {
                "magic": MAGIC,
                "version": VERSION,
                "kind": "sharded",
                "seed": base64.b64encode(index.seed).decode(),
                "options": {"k1": index.options.k1, "b": index.options.b},
                "search_options": {
                    "limit": index.search_options.limit,
                    "prefilter": index.search_options.prefilter,
                },
                "engine": index.engine,
                "axis": index.axis,
                "posting_mode": index.posting_mode,
                "memory_mode": index.memory_mode,
                "strategy": index.strategy,
                "n_shards": index.n_shards,
                "shards": [
                    {
                        "n_docs": v.segment.n_docs,
                        "sum_dl": v.segment.sum_dl,
                    }
                    for v in index.views
                ],
            }
            with open(os.path.join(gen_dir, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            for i, view in enumerate(index.views):
                save_segment(
                    view.segment, os.path.join(gen_dir, f"shard-{i:03d}.npz")
                )
            np.save(os.path.join(gen_dir, "deleted.npy"), index.deleted)
            _write_growing_jsonl(
                index.growing, os.path.join(gen_dir, "growing.jsonl")
            )
            _fsync_dir(gen_dir)

        _commit_generation(directory, write_files)
        _truncate_wal(index, directory)


def open_sharded_index(directory: str, device="cuda"):
    """Load a sharded index onto ``device``, replay its WAL, and attach it
    so subsequent mutations are durable without a full checkpoint."""
    index = load_sharded_index(directory, device=device)
    index.attach_wal(Wal(os.path.join(directory, "wal.log")))
    return index


def load_sharded_index(directory: str, device="cuda"):
    """Load a sharded-index checkpoint with its shards stacked on
    ``device`` (the reference's mesh, one card)."""
    from ..parallel.shard import ShardedIndex

    current_path = os.path.join(directory, "CURRENT")
    if os.path.exists(current_path):
        with open(current_path) as f:
            base = os.path.join(directory, f.read().strip())
    else:
        base = directory
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC or meta.get("version") != VERSION:
        raise ValueError(
            f"on-disk index format mismatch (found "
            f"{meta.get('magic')}/{meta.get('version')}, expected "
            f"{MAGIC}/{VERSION}); rebuild the index"
        )
    if meta.get("kind") != "sharded":
        raise ValueError(
            "not a sharded-index checkpoint; use load_index instead"
        )
    options = IndexOptions(**meta["options"])
    shards = [
        load_segment(
            os.path.join(base, f"shard-{i:03d}.npz"),
            options,
            meta["shards"][i]["n_docs"],
            meta["shards"][i]["sum_dl"],
        )
        for i in range(meta["n_shards"])
    ]
    index = ShardedIndex(
        shards,
        options,
        device=device,
        axis=meta.get("axis", "d"),
        engine=meta.get("engine", "exact"),
        posting_mode=meta.get("posting_mode", "impact"),
        memory_mode=meta.get("memory_mode", "fast"),
        strategy=meta.get("strategy", "auto"),
        seed=base64.b64decode(meta["seed"]),
        search_options=SearchOptions(**meta["search_options"]),
    )
    deleted = np.load(os.path.join(base, "deleted.npy"))
    if deleted.any():
        index.set_deleted(deleted)

    def mark(slot):
        index.growing.deleted[slot] = True

    _replay_growing_jsonl(
        os.path.join(base, "growing.jsonl"), index.growing.insert, mark
    )
    _replay_wal(os.path.join(directory, "wal.log"), index, "_deleted_dirty")
    return index
