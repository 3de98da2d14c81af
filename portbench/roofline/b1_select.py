"""B1-select, ``csrc/blockmax_round.cu`` ``round_select``: one round's
candidate ranges and their posting spans.  Least work (``chip_smoke.py``'s
``select_fields``): the ``[Q, R]`` bound rows read once, an active query's
C taken ranges written back, the thresholds read, ``cand_r``, start and
length written, the query terms' CSR spans read and the active queries'
(term, range) groups searched; a compare a bound and log2(lmax) compares a
(term, candidate) search.

Which queries were active in a round is read after the window without a
copy inside it: the loop hands round r the flag ``flags[r]``, so the
flag's offset is the round, and an active query takes C ranges a round
(the rest of its row in its last), each set to -inf in its bound row,
which the batch's row keeps to its end.  A query was active in round r
while r < ceil(taken / C)."""

from .b1_bounds import groups_of

TARGET = ("vectorchord_bm25_tpu_torch.search.blockmax", "round_select")
KERNELS = ("round_select_kernel",)
USES_LAYOUT = False


def capture(args, kwargs):
    flag = kwargs.get("flag")
    return {
        "ub": args[0], "tts": args[4], "q_tid": args[5], "chunk": int(kwargs["chunk"]),
        "lmax": int(kwargs["lmax"]), "round": 0 if flag is None else int(flag.storage_offset()),
    }


def cost(rec, layout):
    ub, q_tid, c = rec["ub"], rec["q_tid"], rec["chunk"]
    q, r = ub.shape
    t = q_tid.shape[1]
    taken = (ub == float("-inf")).sum(dim=1)
    active = (taken + c - 1) // c > rec["round"]
    n_active = int(active.sum())
    spans = int(groups_of(rec["tts"], q_tid)[active].sum())
    n_bytes = 4 * q * r + 4 * n_active * c + 4 * q + 4 * q * c + 8 * q * t * c + 12 * q * t + 4 * spans
    return n_bytes, q * r + n_active * t * c * max(1, rec["lmax"].bit_length())
