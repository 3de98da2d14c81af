"""S1, ``csrc/stream_dense.cu``: the dense reduction's decode, score and
add of every window into a ``[n_q, N+1]`` accumulator, which it writes
once.  Least work: each window's words and meta read once, the window ids
and ordinals and the query spans read, each live lane's ``s1_eff`` read
once (at most N+1 of them), the accumulator written once; four float32
operations a lane (multiply, add, divide, add)."""

from .windows import window_words

TARGET = ("vectorchord_bm25_tpu_torch.search.stream", "stream_dense_accumulate")
KERNELS = ("dense_tiles_kernel",)
USES_LAYOUT = True


def capture(args, kwargs):
    wsrc, q_start = args[6], args[7]
    return {"wsrc": wsrc, "q_start": int(q_start.numel()), "n_q": int(args[9]), "n_docs": int(args[10])}


def cost(rec, layout):
    wsrc = rec["wsrc"].cpu().numpy()
    n_words, lanes, n_win = window_words(layout, wsrc)
    n = rec["n_docs"]
    n_bytes = (
        4 * n_words + 14 * n_win + 8 * wsrc.size + 4 * rec["q_start"]
        + 4 * min(lanes, n + 1) + 4 * rec["n_q"] * (n + 1)
    )
    return n_bytes, 4 * lanes
