"""P1-tf, ``csrc/tf_range_scores.cu``: one Block-Max round's scores in
``posting_mode="tf"``, each posting's score rebuilt from its term
frequency and its doc's fieldnorm.  Least work (``chip_smoke.py``'s
``p1_bound``): each active lane's tf, range-local slot and fieldnorm read
once, the ``[Q, T, C]`` starts and lengths, the ``[Q, T]`` s0, the
``[Q, C]`` candidate ranges and the 256-entry s1 table read, the
``[Q, C, RS]`` f32 rows written once; a multiply, an add, a divide and the
add a lane."""

TARGET = ("vectorchord_bm25_tpu_torch.search.blockmax", "tf_range_scores")
KERNELS = ("TfScorer",)
USES_LAYOUT = False


def capture(args, kwargs):
    lens = args[7]
    q, t, c = lens.shape
    return {"lens": lens, "tf_bytes": args[0].element_size(), "q": q, "t": t, "c": c, "rs": int(kwargs["rs"])}


def cost(rec, layout):
    q, t, c, rs = rec["q"], rec["t"], rec["c"], rec["rs"]
    active = int(rec["lens"].sum())
    n_bytes = active * (rec["tf_bytes"] + 2) + 8 * q * t * c + 4 * q * c * rs + 4 * q * t + 4 * q * c + 1024
    return n_bytes, 4 * active
