"""B1-bounds, ``csrc/blockmax_round.cu`` ``range_bounds``: every query's
dense ``[R]`` row of per-range upper bounds.  Least work
(``chip_smoke.py``'s ``b1_check``): the query terms and their CSR spans
read, each of their (range, ub) groups read once, the ``[Q, R]`` rows
written once; an add a group and a multiply a range."""

TARGET = ("vectorchord_bm25_tpu_torch.search.blockmax", "range_bounds")
KERNELS = ("range_bounds_kernel",)
USES_LAYOUT = False


def capture(args, kwargs):
    return {"tts": args[0], "q_tid": args[3], "n_ranges": int(kwargs["n_ranges"])}


def groups_of(tts, q_tid):
    """``[Q]`` (term, range) groups of each query's terms (the pad term's
    span is empty)."""
    tid = q_tid.long()
    return (tts[tid + 1] - tts[tid]).sum(dim=1)


def cost(rec, layout):
    q, t = rec["q_tid"].shape
    groups = int(groups_of(rec["tts"], rec["q_tid"]).sum())
    r = rec["n_ranges"]
    return 12 * q * t + 8 * groups + 4 * q * r, groups + q * r
