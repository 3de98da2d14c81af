"""``tests/test_concurrent.py`` replayed on the port's ``Bm25Index`` with
``device="cpu"``: threads inserting, selecting and deleting with periodic
vacuums, selects checked against the oracle under the same lock discipline
(the reference's multi-threaded fuzz harness: N clients with an RwLock
keeping Vacuum exclusive vs checked Selects).  Imports are rewritten and
every assertion is the reference's; it runs on ``stream`` and on
``blockmax``."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vectorchord_bm25_tpu_torch import Bm25Index, Query  # noqa: E402,F401
from vectorchord_bm25_tpu_torch.utils.rwlock import RWLock  # noqa: E402

from test_fuzz import Oracle, edit_distance  # noqa: E402
from test_torch_fuzz import random_doc  # noqa: E402
from test_torch_mutation import build  # noqa: E402,F401

torch.set_num_threads(2)


def test_concurrent_fuzz(build):
    vocab = 40
    n_initial = 80
    k = 15
    rng0 = np.random.default_rng(99)
    docs = [random_doc(rng0, vocab) for _ in range(n_initial)]
    index = build(docs)
    oracle = Oracle()
    for p, d in zip(range(n_initial), docs):
        oracle.insert(p, d)

    # Test-side lock: keeps (index op + oracle op) atomic relative to the
    # checked selects, like the reference harness's RwLock.
    harness_lock = RWLock()
    payload_counter = [n_initial]
    counter_lock = threading.Lock()
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            op = rng.choice(["insert", "select", "select", "delete"])
            try:
                if op == "insert":
                    with harness_lock.read():
                        with counter_lock:
                            payload = payload_counter[0]
                            payload_counter[0] += 1
                        d = random_doc(rng, vocab)
                        index.insert(d, payload)
                        oracle.insert(payload, d)
                elif op == "delete":
                    with harness_lock.read():
                        with counter_lock:
                            target = int(rng.integers(0, payload_counter[0]))
                        index.bulkdelete(lambda p: p == target)
                        oracle.delete(lambda p: p == target)
                else:
                    # Checked select: exclusive vs mutations so the oracle
                    # snapshot is consistent.
                    with harness_lock.write():
                        terms = np.unique(
                            rng.integers(0, vocab, size=3)
                        ).tolist()
                        q = Query.from_int_ids(terms)
                        got = index.search(q, k=k)
                        expect = oracle.topk(index, q, k)
                        got_p = [h.payload for h in got]
                        exp_p = [p for _, p in expect]
                        if edit_distance(got_p, exp_p) > 2:
                            # Mismatches must be score ties (float32 vs
                            # float64 + k-boundary ties).
                            for (g, e) in zip(got, expect):
                                if g.payload != e[1] and abs(
                                    g.score - e[0]
                                ) > 1e-3:
                                    errors.append(
                                        f"got {got_p} expect {exp_p}"
                                    )
                                    break
            except Exception as e:  # pragma: no cover
                errors.append(f"{op}: {type(e).__name__}: {e}")

    def vacuumer():
        for _ in range(3):
            with harness_lock.write():
                index.maintain()

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    threads.append(threading.Thread(target=vacuumer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]

    # Final exact check after a last vacuum.
    index.maintain()
    q = Query.from_int_ids(list(range(6)))
    got = [h.payload for h in index.search(q, k=30)]
    expect = [p for _, p in oracle.topk(index, q, 30)]
    assert edit_distance(got, expect) <= 2
