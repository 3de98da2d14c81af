"""``tests/test_fuzz.py`` replayed on the port's ``Bm25Index`` with
``device="cpu"``: a random stream of inserts, selects, deletes and vacuums,
every select against the brute-force oracle (``Bm25Index.evaluate`` over
the live docs), and the final vacuum exact up to score ties.

Each operation is also mirrored into the reference's ``Bm25Index`` (the
same engine and options, the same documents), and at every select and at
the end the port's hits equal the reference's: payloads and scores, bit
for bit.  The oracle, the op stream and the assertions are the
reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu.index.bm25index import Bm25Index as RefIndex  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Document as RefDocument  # noqa: E402
from vectorchord_bm25_tpu.text.intern import Query as RefQuery  # noqa: E402
from vectorchord_bm25_tpu_torch import Bm25Index, Document, Query  # noqa: E402

from test_fuzz import Oracle, edit_distance  # noqa: E402

torch.set_num_threads(2)


def random_doc(rng, vocab):
    n = int(rng.integers(1, 20))
    return Document.from_int_ids(rng.integers(0, vocab, size=n).tolist())


def _hits(hits):
    return [(h.score, h.payload) for h in hits]


@pytest.mark.parametrize(
    "seed,engine",
    [(1, "blockmax"), (2, "blockmax"), (3, "stream"), (4, "maxscore")],
)
def test_fuzz_index_vs_oracle(seed, engine):
    rng = np.random.default_rng(seed)
    vocab = 80
    n_initial = 150
    k = 20

    docs = [random_doc(rng, vocab) for _ in range(n_initial)]
    ref_docs = [RefDocument(keys=d.keys, values=d.values) for d in docs]
    payloads = list(range(n_initial))
    if engine == "maxscore":
        # The pruned stream strategy under the full mutation stream.
        kw = {"engine": "stream", "engine_options": {"strategy": "maxscore"}}
    else:
        kw = {"engine": engine}
    index = Bm25Index.build(docs, payloads=payloads, device="cpu", **kw)
    ref = RefIndex.build(ref_docs, payloads=payloads, seed=index.seed, **kw)
    oracle = Oracle()
    for p, d in zip(payloads, docs):
        oracle.insert(p, d)
    next_payload = n_initial

    ops = rng.choice(
        ["insert"] * 2 + ["select"] * 4 + ["delete"] * 3 + ["vacuum"],
        size=120,
    )
    n_selects = 0
    for op in ops:
        if op == "insert":
            d = random_doc(rng, vocab)
            index.insert(d, next_payload)
            ref.insert(RefDocument(keys=d.keys, values=d.values), next_payload)
            oracle.insert(next_payload, d)
            next_payload += 1
        elif op == "delete":
            target = int(rng.integers(0, next_payload))
            assert index.bulkdelete(lambda p: p == target) == ref.bulkdelete(
                lambda p: p == target
            )
            oracle.delete(lambda p: p == target)
        elif op == "vacuum":
            index.maintain()
            ref.maintain()
        else:  # select
            n_selects += 1
            terms = rng.integers(0, vocab, size=int(rng.integers(1, 5)))
            q = Query.from_int_ids(np.unique(terms).tolist())
            hits = index.search(q, k=k)
            assert _hits(hits) == _hits(
                ref.search(RefQuery(keys=q.keys), k=k)
            ), f"select #{n_selects}: the port != the reference"
            got = [h.payload for h in hits]
            expect = [p for _, p in oracle.topk(index, q, k)]
            dist = edit_distance(got, expect)
            assert dist <= 2, (
                f"select #{n_selects}: edit distance {dist}\n"
                f"got:    {got}\nexpect: {expect}"
            )

    # Final vacuum: comparison should be exact (ties aside).
    index.maintain()
    ref.maintain()
    q = Query.from_int_ids(list(range(5)))
    hits = index.search(q, k=50)
    assert _hits(hits) == _hits(ref.search(RefQuery(keys=q.keys), k=50))
    got = [h.payload for h in hits]
    expect = [p for _, p in oracle.topk(index, q, 50)]
    assert edit_distance(got, expect) <= 2
    assert set(got) == set(expect) or edit_distance(got, expect) <= 2
    assert n_selects > 0
