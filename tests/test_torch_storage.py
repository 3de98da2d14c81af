"""Persistence in the port (``index/storage.py``, ``ops/bitpack.py``) on the
CPU.

- Replays of ``tests/test_storage.py`` (the round trip, the version check;
  its CLI lifecycle runs through the library here, the port has no CLI) and
  of the six tests of ``tests/test_durability.py``, on the port with
  ``device="cpu"``.
- Checkpoints crossing between the two packages in both directions, each
  with a non-empty WAL, for the ``stream`` and ``blockmax`` engines: the
  index that opens serves what the index that wrote serves.
- ``sealed.npz`` members byte-equal between the two packages for the same
  segment; the round-1 layout loads.

Tolerance: none.  Scores cross as floats and are compared for equality.
"""

import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index import storage as ref_storage  # noqa: E402
from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.index.sealed import (  # noqa: E402
    build_sealed_segment as ref_build_sealed_segment,
)
from vectorchord_bm25_tpu.text import intern as ref_intern  # noqa: E402
from vectorchord_bm25_tpu_torch import (  # noqa: E402
    Bm25Index,
    Document,
    Query,
    Wal,
    load_index,
    open_index,
    save_index,
)
from vectorchord_bm25_tpu_torch.index import storage  # noqa: E402
from vectorchord_bm25_tpu_torch.index.sealed import (  # noqa: E402
    SealedSegment,
    segment_from_reference,
)
from vectorchord_bm25_tpu_torch.utils.options import IndexOptions  # noqa: E402

from test_sealed import make_docs as make_ref_docs  # noqa: E402

torch.set_num_threads(2)


def make_docs(rng, n, vocab, **kw):
    return [Document(keys=d.keys, values=d.values) for d in make_ref_docs(rng, n, vocab=vocab, **kw)]


def build(docs, **kw):
    return Bm25Index.build(docs, device="cpu", **kw)


def _ranked(index, q, k=20):
    return [(h.payload, round(h.score, 6)) for h in index.search(q, k=k)]


def _payload_in(*targets):
    return lambda p: p in targets if np.isscalar(p) else np.isin(p, targets)


# --- replay of tests/test_storage.py


class TestPersistence:
    def test_roundtrip(self, rng, tmp_path):
        index = build(make_docs(rng, 40, vocab=10))
        index.insert(Document.from_int_ids([1, 2]), payload=500)
        index.insert(Document.from_int_ids([3]), payload=501)
        index.bulkdelete(lambda p: p == 5 or p == 501)

        d = str(tmp_path / "idx")
        save_index(index, d)
        loaded = load_index(d, device="cpu")

        assert loaded.sealed.n_docs == index.sealed.n_docs
        assert loaded.seed == index.seed
        assert np.array_equal(loaded.deleted, index.deleted)
        assert len(loaded.growing) == 2
        assert loaded.growing.deleted == [False, True]
        assert loaded.device.type == loaded.growing.device.type == "cpu"
        q = Query.from_int_ids([0, 1, 2, 3])
        a = [(h.payload, round(h.score, 5)) for h in index.search(q, k=20)]
        b = [(h.payload, round(h.score, 5)) for h in loaded.search(q, k=20)]
        assert a == b

    def test_version_check(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        save_index(build(make_docs(rng, 5, vocab=3)), d)
        with open(f"{d}/CURRENT") as f:
            gen = f.read().strip()
        with open(f"{d}/{gen}/meta.json") as f:
            meta = json.load(f)
        for key, value in (("version", 999), ("magic", "someone-else")):
            with open(f"{d}/{gen}/meta.json", "w") as f:
                json.dump({**meta, key: value}, f)
            with pytest.raises(ValueError, match="rebuild the index"):
                load_index(d, device="cpu")

    def test_build_search_lifecycle(self, rng, tmp_path):
        # The CLI test's lifecycle (build, search, insert, search, delete,
        # maintain, inspect), each step a fresh open of the directory.
        d = str(tmp_path / "idx")
        docs = [
            Document.from_int_ids(ids)
            for ids in ([1, 2, 3, 4, 5, 6], [7, 8, 9, 10], [11, 10, 12, 9, 13], [14, 1, 15, 16, 14, 5])
        ]
        save_index(build(docs, payloads=[1, 2, 3, 4]), d)
        hits = open_index(d, device="cpu").search(Query.from_int_ids([1, 5]), k=3)
        assert len(hits) >= 2 and hits[0].payload in (1, 4)

        index = open_index(d, device="cpu")
        index.insert(Document.from_int_ids([1, 1, 1]), payload=99)
        save_index(index, d)
        assert 99 in [h.payload for h in open_index(d, device="cpu").search(Query.from_int_ids([1]), k=5)]

        index = open_index(d, device="cpu")
        assert index.bulkdelete_payloads([99]) == 1
        save_index(index, d)
        index = open_index(d, device="cpu")
        index.maintain()
        save_index(index, d)
        index = load_index(d, device="cpu")
        assert index.n_docs == 4 and len(index.growing) == 0


# --- replay of tests/test_durability.py


class TestWalRecovery:
    def test_acknowledged_mutations_survive_reload(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        save_index(build(make_docs(rng, 30, vocab=10)), d)

        # Mutate through the WAL-attached handle; never call save_index.
        index = open_index(d, device="cpu")
        index.insert(Document.from_int_ids([1, 2, 2]), payload=500)
        index.insert(Document.from_int_ids([3]), payload=501)
        index.bulkdelete(_payload_in(5, 501))
        index.insert(Document.from_int_ids([0, 4]), payload=502)
        expected = _ranked(index, Query.from_int_ids([0, 1, 2, 3, 4]))

        # "Crash": reload from disk with no checkpoint taken.
        recovered = load_index(d, device="cpu")
        assert len(recovered.growing) == 3
        assert recovered.growing.deleted == [False, True, False]
        assert recovered.deleted[5]
        assert _ranked(recovered, Query.from_int_ids([0, 1, 2, 3, 4])) == expected

    def test_maintain_is_replayed(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        save_index(build(make_docs(rng, 20, vocab=8)), d)
        index = open_index(d, device="cpu")
        index.insert(Document.from_int_ids([1]), payload=900)
        index.bulkdelete_payloads([3, 7])
        index.maintain()
        index.insert(Document.from_int_ids([2]), payload=901)
        expected = _ranked(index, Query.from_int_ids([1, 2, 3]))

        recovered = load_index(d, device="cpu")
        assert recovered.sealed.n_docs == index.sealed.n_docs
        assert len(recovered.growing) == 1
        assert _ranked(recovered, Query.from_int_ids([1, 2, 3])) == expected

    def test_torn_wal_tail_is_ignored(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        save_index(build(make_docs(rng, 10, vocab=5)), d)
        index = open_index(d, device="cpu")
        index.insert(Document.from_int_ids([1]), payload=700)
        # Simulate a crash mid-append: garbage partial record, no newline.
        with open(os.path.join(d, "wal.log"), "ab") as f:
            f.write(b'{"op": "insert", "payl')
        recovered = load_index(d, device="cpu")
        assert len(recovered.growing) == 1  # acknowledged insert kept
        assert recovered.growing.payloads == [700]

    def test_checkpoint_truncates_wal(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        save_index(build(make_docs(rng, 10, vocab=5)), d)
        index = open_index(d, device="cpu")
        index.insert(Document.from_int_ids([1]), payload=700)
        assert os.path.getsize(os.path.join(d, "wal.log")) > 0
        save_index(index, d)
        assert os.path.getsize(os.path.join(d, "wal.log")) == 0
        recovered = load_index(d, device="cpu")
        assert len(recovered.growing) == 1  # from the checkpoint now
        # WAL handle still works after the reset.
        index.insert(Document.from_int_ids([2]), payload=701)
        assert len(load_index(d, device="cpu").growing) == 2


class TestAtomicCheckpoint:
    def test_crash_mid_save_preserves_previous_generation(self, rng, tmp_path, monkeypatch):
        d = str(tmp_path / "idx")
        index = build(make_docs(rng, 25, vocab=8))
        save_index(index, d)
        before = _ranked(load_index(d, device="cpu"), Query.from_int_ids([0, 1, 2]))

        # Crash while writing the new generation's files — before the
        # CURRENT pointer swap.
        def boom(index, gen_dir):
            with open(os.path.join(gen_dir, "meta.json"), "w") as f:
                f.write('{"partial": true')  # torn file
            raise RuntimeError("simulated crash mid-checkpoint")

        monkeypatch.setattr(storage, "_write_checkpoint_files", boom)
        index.bulkdelete_payloads([0])
        with pytest.raises(RuntimeError, match="simulated crash"):
            save_index(index, d)
        monkeypatch.undo()

        # The previous committed generation still loads, unchanged.
        recovered = load_index(d, device="cpu")
        assert _ranked(recovered, Query.from_int_ids([0, 1, 2])) == before

        # And a later successful save commits + GCs the stale dir.
        save_index(index, d)
        recovered = load_index(d, device="cpu")
        assert recovered.deleted[0]
        gens = [n for n in os.listdir(d) if n.startswith("gen-")]
        assert len(gens) == 1

    def test_generation_numbers_advance(self, rng, tmp_path):
        d = str(tmp_path / "idx")
        index = build(make_docs(rng, 5, vocab=3))
        save_index(index, d)
        save_index(index, d)
        save_index(index, d)
        with open(os.path.join(d, "CURRENT")) as f:
            assert f.read().strip() == "gen-000003"
        gens = [n for n in os.listdir(d) if n.startswith("gen-")]
        assert gens == ["gen-000003"]


# --- what the replays do not reach


def test_unknown_wal_op_raises(rng, tmp_path):
    d = str(tmp_path / "idx")
    save_index(build(make_docs(rng, 10, vocab=5)), d)
    wal = Wal(os.path.join(d, "wal.log"))
    wal.append({"op": "reshard", "n": 2})
    wal.close()
    with pytest.raises(ValueError, match="rebuild the index"):
        load_index(d, device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (load_index, open_index):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_wal_record_format_is_the_references(rng, tmp_path):
    # The facade's three logging sites write what the reference's facade
    # writes for the same mutations, byte for byte.
    logs = []
    for pkg_build, pkg_save, pkg_open, doc_cls, sub in (
        (RefIndex.build, ref_storage.save_index, ref_storage.open_index, ref_intern.Document, "ref"),
        (build, save_index, lambda d: open_index(d, device="cpu"), Document, "port"),
    ):
        d = str(tmp_path / sub)
        docs = [doc_cls(keys=x.keys, values=x.values) for x in make_ref_docs(np.random.default_rng(5), 30, vocab=10)]
        pkg_save(pkg_build(docs, seed=b"s" * 16), d)
        index = pkg_open(d)
        index.insert(doc_cls.from_int_ids([1, 2, 2]), payload=500)
        index.insert(doc_cls.from_int_ids([3]), payload=501)
        index.bulkdelete(_payload_in(5, 7, 501))
        index.maintain()
        index.bulkdelete_payloads([11])
        with open(os.path.join(d, "wal.log"), "rb") as f:
            logs.append(f.read())
    assert logs[0] == logs[1] and logs[0].count(b"\n") == 5


# --- checkpoints crossing between the packages


def _mutate(index, doc_cls):
    index.insert(doc_cls.from_int_ids([1, 2, 2]), payload=9000)
    index.insert(doc_cls.from_int_ids([3, 30]), payload=9001)
    index.bulkdelete(_payload_in(5, 17, 9001))
    index.insert(doc_cls.from_int_ids([0, 4]), payload=9002)


def _served(index, query_cls, rng):
    queries = [
        query_cls.from_int_ids(rng.integers(0, 32, size=3).tolist()) for _ in range(12)
    ] + [query_cls.from_int_ids([1, 2, 3, 0, 4])]
    return [[(h.score, h.payload) for h in hits] for hits in index.search_batch(queries, 320)]


@pytest.mark.parametrize("engine", ["stream", "blockmax"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_between_packages(rng, tmp_path, writer, engine):
    # One package writes a checkpoint, reopens it and logs mutations to the
    # WAL without another checkpoint; the other package opens the directory,
    # replays that WAL and serves the same hits; then it logs a mutation of
    # its own, which the first package reads back.
    d = str(tmp_path / "idx")
    ref_docs = make_ref_docs(rng, 300, vocab=30)
    opts = {"chunk": 2} if engine == "blockmax" else None
    if writer == "reference":
        ref_storage.save_index(
            RefIndex.build(ref_docs, engine=engine, engine_options=opts), d
        )
        live = ref_storage.open_index(d)
        _mutate(live, ref_intern.Document)
        other = open_index(d, device="cpu")
        want = _served(live, ref_intern.Query, np.random.default_rng(1))
        got = _served(other, Query, np.random.default_rng(1))
    else:
        docs = [Document(keys=x.keys, values=x.values) for x in ref_docs]
        save_index(build(docs, engine=engine, engine_options=opts), d)
        live = open_index(d, device="cpu")
        _mutate(live, Document)
        other = ref_storage.open_index(d)
        want = _served(live, Query, np.random.default_rng(1))
        got = _served(other, ref_intern.Query, np.random.default_rng(1))
    assert os.path.getsize(os.path.join(d, "wal.log")) > 0
    assert got == want and any(p >= 9000 for hits in got for _, p in hits)
    assert other.engine_kind == engine and other.engine_options == (opts or {})
    assert len(other.growing) == 3 and other.growing.deleted == [False, True, False]
    assert other.deleted[5] and other.deleted[17]
    # The file route and the by-value route agree.
    if writer == "reference":
        by_value = Bm25Index.from_reference(live, device="cpu")
        assert _served(by_value, Query, np.random.default_rng(1)) == got
    # And back: the second package's acknowledged delete reaches the first.
    live._wal.close()
    assert other.bulkdelete_payloads([23]) == 1
    if writer == "reference":
        assert ref_storage.load_index(d).deleted[23]
    else:
        assert load_index(d, device="cpu").deleted[23]


# --- the bytes on disk


def _segment_with_full_and_partial_blocks(rng):
    # Term 0 is in every doc (several full 128-blocks and a partial one),
    # some term frequencies need more than a byte, the rest are rare terms.
    docs = []
    for i in range(700):
        ids = [0] * int(rng.integers(1, 4)) + rng.integers(1, 60, size=int(rng.integers(0, 6))).tolist()
        if i % 97 == 0:
            ids += [7] * 300
        docs.append(ref_intern.Document.from_int_ids(ids))
    return ref_build_sealed_segment(docs, payloads=np.arange(700, dtype=np.int64) * 3)


@pytest.mark.parametrize("compress", [True, False])
def test_sealed_npz_members_byte_equal(rng, tmp_path, compress):
    ref_seg = _segment_with_full_and_partial_blocks(rng)
    seg = segment_from_reference(ref_seg)
    assert (ref_seg.block_n == 128).any() and (ref_seg.block_n < 128).any()
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_storage.save_segment(ref_seg, a, compress=compress)
    storage.save_segment(seg, b, compress=compress)
    with np.load(a) as fa, np.load(b) as fb:
        assert fa.files == fb.files
        assert ("fd_bytes" in fa.files) == compress
        for name in fa.files:
            x, y = fa[name], fb[name]
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name
    # Each package reads the other's file back to the same segment.
    options = IndexOptions()
    loaded = storage.load_segment(a, options, seg.n_docs, seg.sum_dl)
    assert type(loaded) is SealedSegment
    ref_loaded = ref_storage.load_segment(b, ref_seg.options, ref_seg.n_docs, ref_seg.sum_dl)
    for name in storage._SEGMENT_FIELDS:
        np.testing.assert_array_equal(getattr(loaded, name), getattr(seg, name), err_msg=name)
        np.testing.assert_array_equal(getattr(ref_loaded, name), getattr(seg, name), err_msg=name)
        assert getattr(loaded, name).dtype == getattr(ref_loaded, name).dtype, name


def test_round1_layout_loads(rng, tmp_path):
    # The first on-disk layout: meta.json at the top level, no CURRENT, no
    # WAL, every block bit-packed with its padding (cd_*/ct_* members).
    d = str(tmp_path / "idx")
    index = build(make_docs(rng, 200, vocab=12))
    save_index(index, d)
    gen = os.path.join(d, "gen-000001")
    seg = index.sealed
    arrays = {
        name: getattr(seg, name)
        for name in storage._SEGMENT_FIELDS
        if name not in ("block_docids", "block_tfs")
    }
    bases = seg.block_min_doc.astype(np.uint32)
    # Pad lanes hold n_docs; delta-coding needs them ascending from the base.
    docids = np.maximum.accumulate(seg.block_docids.astype(np.uint32), axis=1)
    for prefix, (data, bits, offsets) in (
        ("cd", storage._bitpack_full(docids, bases)),
        ("ct", storage._bitpack_full(seg.block_tfs.astype(np.uint32))),
    ):
        arrays[f"{prefix}_bytes"], arrays[f"{prefix}_bits"] = data, bits
        arrays[f"{prefix}_offsets"] = offsets
    flat = str(tmp_path / "flat")
    os.makedirs(flat)
    np.savez_compressed(os.path.join(flat, "sealed.npz"), **arrays)
    for name in ("meta.json", "deleted.npy", "growing.jsonl"):
        with open(os.path.join(gen, name), "rb") as src, open(os.path.join(flat, name), "wb") as dst:
            dst.write(src.read())
    loaded = load_index(flat, device="cpu")
    ref_loaded = ref_storage.load_index(flat)
    live = seg.block_docids < seg.n_docs
    for got in (loaded.sealed, ref_loaded.sealed):
        np.testing.assert_array_equal(got.block_docids[live], seg.block_docids[live])
        np.testing.assert_array_equal(got.block_tfs, seg.block_tfs)
    np.testing.assert_array_equal(loaded.sealed.block_docids, ref_loaded.sealed.block_docids)
    q = Query.from_int_ids([0, 1, 2, 3])
    assert _ranked(loaded, q) == _ranked(index, q)
