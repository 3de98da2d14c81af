"""SP-stream, ``csrc/sparse_merge.cu``: the sparse reduction of a
``[Q, P]`` window matrix in one launch (decode, merge each doc's lanes,
select the top-k).  Least work: each window's words and meta and each
window id read once, each live lane's ``s1_eff`` read once (at most N+1),
the segments read, ``[Q, k]`` scores and ids written; three float32
operations a lane."""

from .windows import window_words

TARGET = ("vectorchord_bm25_tpu_torch.search.stream", "stream_sparse_topk")
KERNELS = ("sparse_merge_kernel",)
USES_LAYOUT = True


def capture(args, kwargs):
    return {"wsrc": args[6], "k": int(args[7]), "n_docs": int(args[8]), "seg": int(args[10].numel())}


def cost(rec, layout):
    wsrc = rec["wsrc"].cpu().numpy()
    n_words, lanes, n_win = window_words(layout, wsrc)
    n = rec["n_docs"]
    n_bytes = (
        4 * n_words + 14 * n_win + 4 * wsrc.size + 4 * min(lanes, n + 1)
        + 4 * rec["seg"] + 8 * wsrc.shape[0] * rec["k"]
    )
    return n_bytes, 3 * lanes
