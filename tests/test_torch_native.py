"""The port's native library (``vectorchord_bm25_tpu_torch/native``):
``tests/test_native.py`` replayed on the port's loader, which builds the
library with the host ``g++`` at first use, so these run wherever a
compiler is (the reference's suite skips without a prebuilt library).

- each native entry against its Python or numpy fallback;
- the codec round trips and the external-sort merge with offsets;
- ``save_index`` writes the same bytes with the library and without it,
  and the same bytes as the reference's ``save_index`` of the same index;
- the build: the loader's flags are the Makefile's, and concurrent first
  builds in fresh processes all load one library.

Tolerance: exact equality everywhere.
"""

import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index import storage as ref_storage  # noqa: E402
from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.text import intern as ref_intern  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index, Document, save_index  # noqa: E402
from vectorchord_bm25_tpu_torch.index import storage  # noqa: E402
from vectorchord_bm25_tpu_torch.native import loader  # noqa: E402
from vectorchord_bm25_tpu_torch.parallel import hostbuild  # noqa: E402
from vectorchord_bm25_tpu_torch.text import intern  # noqa: E402
from vectorchord_bm25_tpu_torch.text.blake3 import blake3_keyed_hash  # noqa: E402

from test_sealed import make_docs  # noqa: E402
from test_torch_text import no_native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = [("key", "S16"), ("doc", "<u4"), ("tf", "<u4")]


def test_library_builds_here():
    # g++ is on PATH wherever the tests run, so nothing below may skip.
    assert loader.available(), loader.BUILD_ERROR
    path = loader.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "vectorchord_bm25_tpu_torch", "_build")
    assert re.fullmatch(r"libvcbm25_[0-9a-f]{16}\.so", os.path.basename(path))


def test_flags_are_the_makefiles():
    with open(os.path.join(REPO, "vectorchord_bm25_tpu_torch", "native", "Makefile")) as f:
        text = f.read()
    flags = dict(re.findall(r"^(CXXFLAGS|LDFLAGS) \?= (.*)$", text, re.M))
    assert tuple(flags["CXXFLAGS"].split()) == loader.CXXFLAGS
    assert tuple(flags["LDFLAGS"].split()) == loader.LDFLAGS
    srcs = re.search(r"^SRCS := (.*)$", text, re.M).group(1).split()
    assert sorted(os.path.basename(s) for s in srcs) == [
        os.path.basename(p) for p in loader._sources()
    ]


def test_concurrent_first_builds(tmp_path):
    # Fresh copies of the package (no library built yet) in six processes
    # at once: each loads a whole library, and one file is left.
    import shutil

    pkg = tmp_path / "vectorchord_bm25_tpu_torch"
    shutil.copytree(
        os.path.join(REPO, "vectorchord_bm25_tpu_torch"), pkg,
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    script = (
        "import sys; sys.modules['torch'] = None\n"
        "from vectorchord_bm25_tpu_torch.native import loader\n"
        "fn = loader.blake3_keyed_hash16()\n"
        "assert fn is not None, loader.BUILD_ERROR\n"
        "print(fn(bytes(32), b'abc' * 20).hex())\n"
    )
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    want = blake3_keyed_hash(bytes(32), b"abc" * 20, 32)[:16].hex()
    assert {o.strip() for o, _ in outs} == {want}
    built = os.listdir(pkg / "_build")
    assert len(built) == 1 and built[0].startswith("libvcbm25_"), built


class TestBlake3Native:
    def test_cross_check_python(self):
        fn = loader.blake3_keyed_hash16()
        key = b"whats the Elvish word for friend"
        for n in [0, 1, 31, 63, 64, 65, 100, 1023, 1024, 1025, 2048, 4096, 5000]:
            data = bytes(i % 251 for i in range(n))
            assert fn(key, data) == blake3_keyed_hash(key, data, 32)[:16], n

    def test_intern_batch_matches_scalar(self):
        seed = b"\x42" * 32
        tokens = [
            b"cat", b"a" * 16, b"x\x00y", b"", b"fifteen-chars..",
            b"exactly16bytes!!", b"very long token " * 10,
        ]
        keys = loader.intern_batch(seed, tokens)
        assert keys is not None
        for i, tok in enumerate(tokens):
            want = intern.intern(seed, tok)
            assert keys[i].tobytes().ljust(16, b"\x00")[:16] == want, tok
            assert want == ref_intern.intern(seed, tok), tok

    def test_interning_with_and_without_the_library(self, monkeypatch, rng):
        seed = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        tokens = [bytes(rng.integers(1, 256, size=int(n), dtype=np.uint8)) for n in rng.integers(0, 80, 300)]
        native = [intern.intern(seed, t) for t in tokens]
        no_native(monkeypatch)
        assert [intern.intern(seed, t) for t in tokens] == native


class TestBitpack:
    def test_ordered_roundtrip(self, rng):
        for scale in [0, 1, 3, 100, 2**15, 2**25]:
            base = np.uint32(rng.integers(0, 1000))
            deltas = rng.integers(0, scale + 1, size=(4, 128)).astype(np.uint64)
            vals = (base + np.cumsum(deltas, axis=1)).astype(np.uint32)
            bases = np.full(4, base, dtype=np.uint32)
            packed, bits, offsets = loader.compress_blocks(vals, bases)
            out = loader.decompress_blocks(packed, bits, offsets, bases)
            np.testing.assert_array_equal(out, vals)
            assert offsets[-1] == int(np.sum(bits)) * 16

    def test_unordered_roundtrip(self, rng):
        vals = rng.integers(0, 2**20, size=(8, 128)).astype(np.uint32)
        packed, bits, offsets = loader.compress_blocks(vals)
        np.testing.assert_array_equal(loader.decompress_blocks(packed, bits, offsets), vals)

    def test_compression_ratio_realistic(self, rng):
        docs = np.sort(rng.choice(100000, size=128 * 16, replace=False))
        vals = docs.reshape(16, 128).astype(np.uint32)
        bases = np.concatenate([[0], vals[:-1, -1]]).astype(np.uint32)
        _, _, offsets = loader.compress_blocks(vals, bases)
        assert offsets[-1] < vals.size * 2


def _codec_blocks(rng, n_blocks):
    bases = rng.integers(0, 1 << 20, size=n_blocks).astype(np.uint32)
    gaps = rng.integers(0, 1 << rng.integers(1, 12, size=(n_blocks, 1)), size=(n_blocks, 128))
    docids = (bases[:, None] + np.cumsum(gaps, axis=1)).astype(np.uint32)
    tfs = rng.integers(0, 1 << rng.integers(1, 33, size=(n_blocks, 1)), size=(n_blocks, 128), dtype=np.uint64)
    tfs[0] = 0
    return bases, docids, tfs.astype(np.uint32)


@pytest.mark.parametrize("with_bases", [True, False])
def test_full_block_codecs_equal_their_fallback(rng, monkeypatch, with_bases):
    bases, docids, tfs = _codec_blocks(rng, 33)
    vals, b = (docids, bases) if with_bases else (tfs, None)
    got = storage._bitpack_full(vals, b)
    back = storage._bitunpack_full(*got, b)
    no_native(monkeypatch)
    want = storage._bitpack_full(vals, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(storage._bitunpack_full(*want, b), vals)


@pytest.mark.parametrize("with_bases", [True, False])
def test_partial_block_codecs_equal_their_fallback(rng, monkeypatch, with_bases):
    bases, docids, tfs = _codec_blocks(rng, 33)
    ns = rng.integers(0, 128, size=33)
    ns[:3] = [0, 1, 127]
    vals, b = (docids, bases) if with_bases else (tfs, None)
    got = storage._bytepack_partial(vals, ns, b)
    back = storage._byteunpack_partial(*got, ns, b, fill=77)
    no_native(monkeypatch)
    want = storage._bytepack_partial(vals, ns, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(back, storage._byteunpack_partial(*want, ns, b, fill=77))
    for i, n in enumerate(ns):
        np.testing.assert_array_equal(back[i, :n], vals[i, :n])
        assert (back[i, n:] == 77).all()


class TestExtSort:
    def _write_records(self, path, keys, docs, tfs):
        rec = np.zeros(len(keys), dtype=REC)
        rec["key"], rec["doc"], rec["tf"] = keys, docs, tfs
        rec.tofile(path)

    def test_sort_file(self, rng, tmp_path):
        path = str(tmp_path / "run.bin")
        n = 1000
        keys = np.array([f"tok{int(x):06d}".encode() for x in rng.integers(0, 50, n)], dtype="S16")
        self._write_records(
            path, keys, rng.integers(0, 10000, n).astype(np.uint32),
            rng.integers(1, 5, n).astype(np.uint32),
        )
        assert loader.sort_mappings_file(path)
        out = np.fromfile(path, dtype=REC)
        pairs = list(zip(out["key"].tolist(), out["doc"].tolist()))
        assert pairs == sorted(pairs) and len(out) == n

    def test_merge_with_offsets_equals_the_numpy_merge(self, rng, tmp_path, monkeypatch):
        # io.rs's doc-id offset rebasing: per-worker runs merge into one
        # doc-id space; the native merge and hostbuild's numpy fallback
        # write the same file, and the counter counts native merges only.
        runs, offsets = [], [0, 100, 250]
        for w in range(3):
            path = str(tmp_path / f"run{w}.bin")
            n = 50
            keys = np.array([f"t{int(x):04d}".encode() for x in rng.integers(0, 20, n)], dtype="S16")
            docs = rng.choice(100, size=n, replace=False).astype(np.uint32)
            self._write_records(path, keys, docs, np.full(n, w + 1, dtype=np.uint32))
            assert loader.sort_mappings_file(path)
            runs.append(path)
        group = list(zip(runs, offsets))
        loader.MERGES = 0
        native = str(tmp_path / "native.bin")
        hostbuild._merge_group(group, native)
        assert loader.MERGES == 1
        no_native(monkeypatch)
        fallback = str(tmp_path / "numpy.bin")
        hostbuild._merge_group(group, fallback)
        assert loader.MERGES == 1
        with open(native, "rb") as a, open(fallback, "rb") as b:
            assert a.read() == b.read()
        out = np.fromfile(native, dtype=REC)
        assert out.size == 150
        assert sorted(zip(out["key"].tolist(), out["doc"].tolist())) == list(
            zip(out["key"].tolist(), out["doc"].tolist())
        )


def _checkpoint_bytes(directory):
    """Every file of a checkpoint directory: npz archives member by member
    (a zip stamps its members with the time they were written), every
    other file whole."""
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, directory)
            if name.endswith(".npz"):
                with zipfile.ZipFile(path) as z:
                    out[rel] = {m: z.read(m) for m in z.namelist()}
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("engine", ["stream", "blockmax"])
def test_save_index_bytes_with_and_without_the_library(rng, tmp_path, monkeypatch, engine):
    ref_docs = make_docs(rng, 900, vocab=50)
    for i in range(0, 900, 113):  # blocks of wide term frequencies
        ref_docs[i] = ref_intern.Document.from_int_ids([0] * 70000 + [1, 2])
    docs = [Document(keys=d.keys, values=d.values) for d in ref_docs]
    seed = bytes(range(32))
    payloads = np.arange(900, dtype=np.int64) * 5 + 1
    index = Bm25Index.build(docs, payloads=payloads, seed=seed, engine=engine, device="cpu")
    ref = RefIndex.build(ref_docs, payloads=payloads, seed=seed, engine=engine)
    assert (index.sealed.block_n == 128).any() and (index.sealed.block_n < 128).any()
    for i, (d, r) in enumerate(zip(docs[:5], ref_docs[:5])):
        index.insert(d, 10_000 + i)
        ref.insert(r, 10_000 + i)
    for x in (index, ref):
        x.bulkdelete(lambda p: p % 7 == 0)
    save_index(index, str(tmp_path / "native"))
    ref_storage.save_index(ref, str(tmp_path / "reference"))
    no_native(monkeypatch)
    save_index(index, str(tmp_path / "numpy"))
    native = _checkpoint_bytes(tmp_path / "native")
    assert any(k.endswith("sealed.npz") for k in native)
    assert native == _checkpoint_bytes(tmp_path / "numpy")
    assert native == _checkpoint_bytes(tmp_path / "reference")
