"""The port's text pipeline against the reference's: ``tests/test_tokenizer.py``
and ``tests/test_tokenizer_parity.py`` replayed on
``vectorchord_bm25_tpu_torch.text``, and the two packages' ``stem``,
``tsvector``, ``tokenize_query`` and ``documents_from_texts`` held equal on
the suites' texts and on seeded random text, with the port's native
library and without it.  Tolerance: exact equality everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.text import corpus as ref_corpus  # noqa: E402
from vectorchord_bm25_tpu.text import porter2 as ref_porter2  # noqa: E402
from vectorchord_bm25_tpu.text import tokenizer as ref_tokenizer  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index  # noqa: E402
from vectorchord_bm25_tpu_torch.native import loader  # noqa: E402
from vectorchord_bm25_tpu_torch.text.corpus import (  # noqa: E402
    document_from_counts,
    documents_from_texts,
)
from vectorchord_bm25_tpu_torch.text.intern import (  # noqa: E402
    Document,
    Query,
    random_seed,
)
from vectorchord_bm25_tpu_torch.text.porter2 import stem  # noqa: E402
from vectorchord_bm25_tpu_torch.text.tokenizer import (  # noqa: E402
    STOPWORDS,
    tokenize_query,
    tsvector,
)

from test_tokenizer import TOY_CORPUS  # noqa: E402
from test_tokenizer_parity import CASES  # noqa: E402

KNOWN_STEMS = {
    "flies": "fli",
    "dies": "die",
    "agreed": "agre",
    "national": "nation",
    "relational": "relat",
    "databases": "databas",
    "community": "communiti",
    "probabilistic": "probabilist",
    "retrieval": "retriev",
    "important": "import",
    "effective": "effect",
    "queries": "queri",
    "using": "use",
    "generously": "generous",
    "postgresql": "postgresql",
}


def no_native(monkeypatch):
    """Run the port as it runs where no ``g++`` is found: every loader
    entry returns None and the callers take their Python paths."""
    monkeypatch.setattr(loader, "_load", lambda: None)
    monkeypatch.setattr(loader, "blake3_keyed_hash16", lambda: None)


def random_texts(seed, n):
    """Seeded text mixing the tokenizer's classes: stemmed English words,
    stopwords, hyphenated compounds, numbers, versions, emails, hosts,
    urls, paths, apostrophes, underscores, unicode words, long words that
    intern by hash, and punctuation."""
    rng = np.random.default_rng(seed)
    words = sorted(set(TOY_CORPUS[0].split() + list(KNOWN_STEMS) + sorted(STOPWORDS)[:40]))
    words += [
        "state-of-the-art", "object-relational", "don't", "it's", "snake_case",
        "bob@example.com", "www.pg.org/docs", "https://a.b.org/x?y=1", "/usr/bin/env",
        "3.14", "1.2.3", "192.168.0.1", "beta2", "café", "naïve", "Fußball",
        "日本語", "Ελληνικά", "смысл", "em—dash", "U.S.A", "a--b", "-lead",
        "internationalization", "counterrevolutionaries", "electroencephalographs",
        "(see", "foo.txt)", "end.", "Hello,", "world!", "RANKING", "Searching",
    ]
    out = []
    for _ in range(n):
        picks = rng.integers(0, len(words), size=int(rng.integers(0, 40)))
        out.append(" ".join(words[i] for i in picks))
    return out


class TestPorter2:
    @pytest.mark.parametrize("word", sorted(KNOWN_STEMS))
    def test_known_stems(self, word):
        assert stem(word) == KNOWN_STEMS[word] == ref_porter2.stem(word)

    def test_short_words_unchanged(self):
        assert stem("at") == "at"
        assert stem("be") == "be"

    def test_stems_equal_reference_on_random_words(self):
        rng = np.random.default_rng(17)
        letters = np.array(list("abcdefghijklmnopqrstuvwxyyeeiiaaoouu"))
        words = [
            "".join(rng.choice(letters, size=int(rng.integers(1, 16))))
            for _ in range(3000)
        ]
        words += sorted({w.lower() for t in TOY_CORPUS for w in t.split()})
        assert [stem(w) for w in words] == [ref_porter2.stem(w) for w in words]


class TestTsvector:
    def test_stopwords_dropped(self):
        v = tsvector("the quick and the dead")
        assert v == {"quick": 1, "dead": 1}

    def test_positions_counted(self):
        assert tsvector("search search searching")["search"] == 3

    def test_hyphenated_compound(self):
        assert tsvector("object-relational") == {"object-rel": 1, "object": 1, "relat": 1}
        assert tsvector("quick-brown fox") == {
            "quick-brown": 1, "quick": 1, "brown": 1, "fox": 1,
        }

    def test_numwords_kept(self):
        v = tsvector("over 15 years bm25")
        assert v["15"] == 1 and v["bm25"] == 1

    def test_position_cap(self):
        assert tsvector(" ".join(["word"] * 300))["word"] == 256

    def test_email_url_version_kept_whole(self):
        v = tsvector("mail me at bob@example.com about v1.2.3 or www.foo.org/docs")
        assert v["bob@example.com"] == 1
        assert v["1.2.3"] == 1
        assert any(k.startswith("www.foo.org") for k in v)

    def test_file_path_kept_whole(self):
        assert tsvector("see /usr/local/bin/tool for details")["/usr/local/bin/tool"] == 1

    def test_accented_uppercase_lowering(self):
        assert tsvector("Café RÉSUMÉ") == {"café": 1, "résumé": 1}


@pytest.mark.parametrize("text,expected", CASES, ids=lambda v: repr(v)[:40])
def test_tsvector_parity(text, expected):
    # PostgreSQL's to_tsvector('english', ...) as the reference pins it,
    # keys and counts, and the reference's own output.
    got = tsvector(text)
    assert got == expected
    assert list(got.items()) == list(ref_tokenizer.tsvector(text).items())
    assert tokenize_query(text) == ref_tokenizer.tokenize_query(text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_text_equals_reference(seed):
    texts = random_texts(seed, 300)
    for text in texts:
        got = tsvector(text)
        assert list(got.items()) == list(ref_tokenizer.tsvector(text).items()), text
        assert tokenize_query(text) == ref_tokenizer.tokenize_query(text), text


@pytest.mark.parametrize("native", [True, False])
def test_documents_from_texts_equal_reference(monkeypatch, native):
    # The reference's loader finds no prebuilt library here, so it interns
    # with its Python blake3; the port with its native library and without
    # it must give the same keys and values.
    if native:
        assert loader.available(), loader.BUILD_ERROR
    else:
        no_native(monkeypatch)
    seed = bytes(range(32))
    texts = TOY_CORPUS + random_texts(5, 200) + ["", "THE THE", "x" * 40]
    got = documents_from_texts(seed, texts)
    want = ref_corpus.documents_from_texts(seed, texts)
    assert len(got) == len(want) == len(texts)
    assert all(type(d) is Document for d in got)
    for g, w in zip(got, want):
        assert g.keys.dtype == w.keys.dtype and g.values.dtype == w.values.dtype
        np.testing.assert_array_equal(g.keys, w.keys)
        np.testing.assert_array_equal(g.values, w.values)
    hashed = [k for d in got for k in d.keys.tolist() if k[-1:] != b"\x00"]
    assert hashed, "no token long enough to be hashed"
    counts = {"internationalization": 3, "a": 1, "b": 0}
    d, r = document_from_counts(seed, counts), ref_corpus.document_from_counts(seed, counts)
    np.testing.assert_array_equal(d.keys, r.keys)
    np.testing.assert_array_equal(d.values, r.values)


class TestToyCorpusAnchor:
    @pytest.mark.parametrize("engine", ["stream", "exact", "blockmax"])
    def test_readme_ranking(self, engine):
        # The reference README's 10 documents, queried "PostgreSQL": ids
        # 8, 9, 4, 1, 7, 2 in that order, on the port served on the CPU.
        seed = random_seed()
        docs = [Document.from_token_counts(seed, tsvector(t)) for t in TOY_CORPUS]
        index = Bm25Index.build(
            docs, payloads=list(range(1, 11)), engine=engine, device="cpu"
        )
        q = Query.from_tokens(seed, tsvector("PostgreSQL").keys())
        hits = index.search(q, k=10)
        assert [h.payload for h in hits] == [8, 9, 4, 1, 7, 2]
        ops = [h.operator_score for h in hits]
        assert ops == sorted(ops)
