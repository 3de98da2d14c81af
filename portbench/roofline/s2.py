"""S2, ``csrc/dense_topk.cu``: the exact top-k of each accumulator row.
Least work: the rows' doc columns read once, ``[Q, k]`` scores and ids
written once; one compare a column."""

TARGET = ("vectorchord_bm25_tpu_torch.search.stream", "dense_topk")
KERNELS = ("block_max_keys_kernel", "dense_topk_select_kernel", "sort_chunks_kernel", "rank_merge_kernel")
USES_LAYOUT = False


def capture(args, kwargs):
    acc, k, n_docs = args[0], int(args[1]), int(args[2])
    return {"q": int(acc.shape[0]), "k": k, "n_docs": n_docs}


def cost(rec, layout):
    q, k, n = rec["q"], rec["k"], rec["n_docs"]
    return 4 * q * n + 8 * q * k, q * n
