"""S5, ``csrc/stream_rescore.cu``: MaxScore's exact rescore of each
query's candidates and its top-k, in one launch.  Least work: the
candidates, their ``s1_eff`` entries, the term spans and each window some
candidate falls in (its words and meta) read once, ``[Q, k]`` scores and
ids written; four float32 operations a (candidate, term) pair."""

import numpy as np

from .windows import window_words

TARGET = ("vectorchord_bm25_tpu_torch.search.stream", "rescore_topk")
KERNELS = ("stream_rescore_kernel",)
USES_LAYOUT = True


def capture(args, kwargs):
    return {"cand": args[6], "t_lo": args[7], "t_hi": args[8], "k": int(args[9]), "n_docs": int(args[10])}


def cost(rec, layout):
    cand, t_lo, t_hi = (rec[x].cpu().numpy() for x in ("cand", "t_lo", "t_hi"))
    n = rec["n_docs"]
    wins = []
    for qi in range(cand.shape[0]):
        cq = cand[qi][cand[qi] < n]
        if not cq.size:
            continue
        for lo, hi in zip(t_lo[qi].tolist(), t_hi[qi].tolist()):
            if hi > lo:
                w = lo + np.searchsorted(layout.w_base[lo:hi], cq, side="right") - 1
                wins.append(w[w >= lo])
    uniq = np.unique(np.concatenate(wins)) if wins else np.zeros(0, dtype=np.int64)
    n_words, _, n_win = window_words(layout, uniq)
    read = 4 * n_words + 14 * n_win + 4 * cand.size + 4 * int((cand < n).sum()) + 8 * t_lo.size
    return read + 8 * cand.shape[0] * rec["k"], 4 * cand.size * t_lo.shape[1]
