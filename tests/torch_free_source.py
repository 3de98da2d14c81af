"""Text sources for ``build_out_of_core`` that the port's spawned build
workers unpickle.  They live apart from the test files so that a worker
imports none of what the tests import: the workers must never import
torch or touch CUDA, and ``TorchFreeSource`` fails in a process that has
(``tests/test_torch_hostbuild.py``)."""

import sys


class TextsSource:
    """A list of texts behind ``source(lo, hi)``."""

    def __init__(self, texts):
        self.texts = list(texts)

    def __call__(self, lo, hi):
        return self.texts[lo:hi]


class TorchFreeSource:
    def __init__(self, n_words: int):
        self.n_words = n_words

    def __call__(self, lo, hi):
        loaded = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("torch", "jax", "vectorchord_bm25_tpu")
            and sys.modules[m] is not None
        )
        if loaded:
            raise RuntimeError(f"a build worker loaded {loaded[:5]}")
        return texts(self.n_words, lo, hi)


def texts(n_words, lo, hi):
    return [
        f"worker text doc{i % 23} word{i % n_words} shared token{i % 5} "
        f"extraordinarily-hyphenated-compound{i % 3}"
        for i in range(lo, hi)
    ]
