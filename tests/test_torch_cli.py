"""The port's command line (``vectorchord_bm25_tpu_torch/cli.py``) on the
CPU, against the reference's (``vectorchord_bm25_tpu/cli.py``).

- ``tests/test_storage.py::TestCli``'s lifecycle on ``--device cpu``, with
  the same assertions.
- A checkpoint built by the reference's CLI: ``search`` and ``inspect``
  through both CLIs print the same stdout, byte for byte, before and after
  each ``insert``, ``delete`` and ``maintain``, which the port's CLI runs
  on one copy and the reference's on another.
- ``build`` through each CLI with each engine: both CLIs print the same
  lines for the same checkpoint, and the two checkpoints (each interned
  with its own ``random_seed()``) rank by the reference's sharded-vs-single
  rule: the same hit counts, a rank may differ only between scores within
  1e-4, scores within rtol 2e-5.
- ``build --workers 2`` (the out-of-core build) equals ``--workers 1``
  byte for byte on one seed.
- ``python -m vectorchord_bm25_tpu_torch.cli`` as a subprocess.
- ``--device cuda`` where torch sees no card exits non-zero and writes
  nothing.

The commands run in process (``main(argv)``) unless a subprocess is named.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu import cli as ref_cli  # noqa: E402
from vectorchord_bm25_tpu_torch import cli  # noqa: E402
from vectorchord_bm25_tpu_torch.text import intern  # noqa: E402
from vectorchord_bm25_tpu_torch.text.tokenizer import tsvector  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Words of the generated corpus: a Zipf draw over them, with a few long
# lexemes (16 bytes or more after stemming, so interned by hash).
WORDS = [
    "postgres", "database", "index", "search", "ranking", "query", "token",
    "segment", "posting", "block", "score", "document", "vacuum", "insert",
    "delete", "maintain", "merge", "compress", "window", "stream", "engine",
    "kernel", "device", "memory", "cluster", "shard", "replica", "commit",
    "journal", "checkpoint", "tokenizer", "stemming", "lexeme", "weight",
    "frequency", "length", "average", "bound", "prune", "certify",
    "internationalization", "electroencephalograph", "counterrevolutionary",
    "incomprehensibility", "telecommunications",
]
QUERIES = [
    "postgres database",
    "ranking search engine",
    "internationalization electroencephalograph counterrevolutionary",
    "block posting compress window",
    "vacuum",
    "shard replica commit journal checkpoint",
    "absentword",
    "score weight frequency length",
]


def write_corpus(path, n_docs=400, seed=3):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.9
    p /= p.sum()
    with open(path, "w") as f:
        for i in range(n_docs):
            words = rng.choice(WORDS, size=int(rng.integers(3, 30)), p=p)
            f.write(json.dumps({"id": 10 * i + 7, "text": " ".join(words)}) + "\n")
    return str(path)


def run(module, *args):
    """``module.main(args)`` in process; its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main([str(a) for a in args])
    return out.getvalue()


def port(*args):
    return run(cli, "--device", "cpu", *args)


def ref(*args):
    return run(ref_cli, *args)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    return env


def hits_of(stdout):
    """``search``'s lines as (payload, score) pairs."""
    rows = [line.split("\t") for line in stdout.splitlines() if line]
    assert all(len(r) == 3 for r in rows), stdout
    return [(int(p), float(s)) for _, p, s in rows]


def held_to(got, want):
    """The reference's sharded-vs-single rule (tests/test_sharded.py:43-50)
    on two runs of ``search``."""
    assert len(got) == len(want)
    gs = np.array([s for _, s in got], dtype=np.float64)
    ws = np.array([s for _, s in want], dtype=np.float64)
    np.testing.assert_allclose(gs, ws, rtol=2e-5, atol=0.0)
    for i, ((gp, _), (wp, _)) in enumerate(zip(got, want)):
        if gp != wp:
            assert abs(gs[i] - ws[i]) < 1e-4, (i, got, want)


class TestLifecycle:
    """tests/test_storage.py::TestCli on the port, ``--device cpu``."""

    def test_build_search_lifecycle(self, tmp_path):
        corpus = tmp_path / "corpus.jsonl"
        corpus.write_text(
            "\n".join(
                json.dumps({"id": i + 1, "text": t})
                for i, t in enumerate(
                    [
                        "PostgreSQL is a powerful database system",
                        "full text search with ranking",
                        "BM25 ranking for search engines",
                        "the PostgreSQL community improves the database",
                    ]
                )
            )
        )
        idx = str(tmp_path / "idx")
        out = port("build", "--input", corpus, "--index", idx)
        assert "built: 4 docs" in out

        out = port("search", "--index", idx, "--query", "postgresql database", "-k", "3")
        lines = [l for l in out.splitlines() if l]  # noqa: E741
        assert len(lines) >= 2
        top_payload = int(lines[0].split("\t")[1])
        assert top_payload in (1, 4)

        port("insert", "--index", idx, "--text", "postgresql postgresql postgresql",
             "--payload", "99")
        out = port("search", "--index", idx, "--query", "postgresql", "-k", "5")
        assert "\t99\t" in out

        out = port("delete", "--index", idx, "--payload", "99")
        assert "deleted 1" in out
        port("maintain", "--index", idx)
        info = json.loads(port("inspect", "--index", idx))
        assert info["n_docs"] == 4
        assert info["growing_docs"] == 0


def _views(idx):
    """What a user reads of a checkpoint: every query's ``search`` at two
    depths and ``inspect`` (with and without a token)."""
    views = []
    for q in QUERIES:
        for k in (5, 50):
            views.append(("search", "--index", idx, "--query", q, "-k", k))
    views.append(("inspect", "--index", idx))
    for word in ("electroencephalograph", "postgres"):
        views.append(("inspect", "--index", idx, "--token", *tsvector(word)))
    views.append(("inspect", "--index", idx, "--token", "absentword"))
    return views


def test_reference_checkpoint_prints_the_same(tmp_path):
    corpus = write_corpus(tmp_path / "corpus.jsonl")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    r = subprocess.run(
        [sys.executable, "-m", "vectorchord_bm25_tpu.cli", "build", "--input", corpus,
         "--index", a],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert "built: 400 docs" in r.stdout
    shutil.copytree(a, b)

    def same(step):
        # Each package reads both copies: one mutated by the reference's
        # CLI (a), one by the port's (b).
        for view in _views(a):
            want = ref(*view)
            assert bool(want) != ("absentword" in view and view[0] == "search"), view
            assert port(*view) == want, view
            other = tuple(b if x == a else x for x in view)
            assert ref(*other) == want, (step, view)
            assert port(*other) == want, (step, view)

    same("built")
    steps = [
        ("insert", "--text", "postgres database internationalization", "--payload", 9001),
        ("insert", "--text", "vacuum vacuum shard", "--payload", 9002),
        ("delete", "--payload", 17),
        ("delete", "--payload", 9002),
        ("delete", "--payload", 123456),
        ("maintain",),
        ("insert", "--text", "ranking ranking", "--payload", 9003),
    ]
    for step in steps:
        cmd, *rest = step
        want = ref(cmd, "--index", a, *rest)
        assert port(cmd, "--index", b, *rest) == want, step
        same(step)
    assert "deleted 1 documents" in ref("delete", "--index", a, "--payload", 27)
    assert "deleted 1 documents" in port("delete", "--index", b, "--payload", 27)
    same("last delete")
    info = json.loads(ref("inspect", "--index", b))
    # 400 docs, 17 and 27 deleted, 9001 merged, 9003 growing.
    assert info["growing_docs"] == 1 and info["n_live"] == 400


ENGINES = [
    ("exact",),
    ("blockmax",),
    ("hybrid",),
    ("stream", "--strategy", "sparse"),
    ("stream", "--strategy", "maxscore"),
]


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: "-".join(e[::2]))
def test_build_each_engine_like_the_reference(tmp_path, engine):
    corpus = write_corpus(tmp_path / "corpus.jsonl", seed=len(engine[0]))
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    opts = ("--engine", *engine)
    want = ref("build", "--input", corpus, "--index", a, *opts)
    got = port("build", "--input", corpus, "--index", b, *opts)
    # The counts are seed-free; the terms' order is not.
    assert got.replace(b, a) == want
    info_a = json.loads(ref("inspect", "--index", a))
    info_b = json.loads(port("inspect", "--index", b))
    assert info_a == info_b and info_a["engine"] == engine[0]
    for q in QUERIES:
        for k in (5, 50):
            ref_hits = ref("search", "--index", a, "--query", q, "-k", k)
            # The same checkpoint prints the same through both CLIs...
            assert port("search", "--index", a, "--query", q, "-k", k) == ref_hits
            # ...and the two checkpoints rank alike.
            got = hits_of(port("search", "--index", b, "--query", q, "-k", k))
            held_to(got, hits_of(ref_hits))
            assert bool(got) == (q != "absentword"), q


def test_workers_equal_one_worker(tmp_path, monkeypatch):
    corpus = write_corpus(tmp_path / "corpus.jsonl", n_docs=600)
    seed = bytes(range(32))
    monkeypatch.setattr(intern, "random_seed", lambda: seed)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    out1 = port("build", "--input", corpus, "--index", one, "--workers", 1)
    out2 = port("build", "--input", corpus, "--index", two, "--workers", 2)
    assert out1.replace(one, two) == out2
    for view in _views(one):
        other = tuple(two if x == one else x for x in view)
        assert port(*view) == port(*other), view


def test_module_runs_as_a_subprocess(tmp_path):
    corpus = write_corpus(tmp_path / "corpus.jsonl", n_docs=120)
    idx = str(tmp_path / "idx")
    port("build", "--input", corpus, "--index", idx)
    want = port("search", "--index", idx, "--query", QUERIES[0], "-k", 10)
    assert want
    r = subprocess.run(
        [sys.executable, "-m", "vectorchord_bm25_tpu_torch.cli", "--device", "cpu", "search",
         "--index", idx, "--query", QUERIES[0], "-k", "10"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout == want


def test_device_from_the_environment(tmp_path, monkeypatch):
    corpus = write_corpus(tmp_path / "corpus.jsonl", n_docs=50)
    idx = str(tmp_path / "idx")
    port("build", "--input", corpus, "--index", idx)
    want = port("search", "--index", idx, "--query", QUERIES[0])
    monkeypatch.setenv("VCBM25_DEVICE", "cpu")
    assert run(cli, "search", "--index", idx, "--query", QUERIES[0]) == want


@pytest.mark.parametrize("where", ["flag", "default"])
def test_cuda_without_a_card_fails_and_writes_nothing(tmp_path, monkeypatch, capsys, where):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")
    corpus = write_corpus(tmp_path / "corpus.jsonl", n_docs=50)
    built = str(tmp_path / "built")
    port("build", "--input", corpus, "--index", built)
    before = sorted(os.listdir(built))
    fresh = tmp_path / "fresh"
    monkeypatch.delenv("VCBM25_DEVICE", raising=False)
    for argv in (
        ["build", "--input", corpus, "--index", str(fresh)],
        ["search", "--index", built, "--query", "postgres"],
        ["insert", "--index", built, "--text", "postgres", "--payload", "5"],
        ["delete", "--index", built, "--payload", "7"],
        ["maintain", "--index", built],
        ["inspect", "--index", built],
    ):
        if where == "flag":
            argv = ["--device", "cuda:0"] + argv
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code != 0, argv
        err = capsys.readouterr()
        assert "torch sees no CUDA device" in err.err and not err.out, argv
    assert not fresh.exists()
    assert sorted(os.listdir(built)) == before
    assert not os.path.exists(os.path.join(built, "wal.log")) or os.path.getsize(
        os.path.join(built, "wal.log")
    ) == 0
