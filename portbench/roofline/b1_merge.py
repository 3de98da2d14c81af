"""B1-merge, ``csrc/blockmax_round.cu`` ``round_merge``: one round's
``[Q, C, RS]`` scores masked by the live and filter tables and merged into
the running top-k (the register kernel for k <= 32, the shared-memory
buffer kernel above).  Least work: the scores and ``cand_r`` read once,
the ``[Q, k]`` top-k read and written.

``chip_smoke.py``'s ``b1_merge_fields`` also counts the live and filter
entries of each lane that scored (8 B a lane) and three operations a
lane.  Which lanes scored only the round's scores tell, and counting them
inside the profiled steps adds a reduction a round there, which on one
H100 moved the program's loop span by more than the term it adds (about
4% of this bound in the cell at k=100).  So they are left out: the share
read is a lower figure, never a higher one."""

TARGET = ("vectorchord_bm25_tpu_torch.search.blockmax", "round_merge")
KERNELS = ("round_merge_reg_kernel", "round_merge_kernel")
USES_LAYOUT = False


def capture(args, kwargs):
    q, c, rs = args[0].shape
    return {"q": q, "c": c, "rs": rs, "k": int(args[4].shape[1])}


def cost(rec, layout):
    q, c, rs, k = rec["q"], rec["c"], rec["rs"], rec["k"]
    return 4 * q * c * rs + 4 * q * c + 16 * q * k, 0
