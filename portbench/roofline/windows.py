"""The stream index's windows, as the kernels' byte counts read them.

The count reads the layout of ``index/stream.py`` as it stands: each
window holds ``w_len`` postings, its doc deltas at ``w_dbits`` bits and
its tfs at ``w_tfbits`` bits, each side rounded up to whole u32 words, and
14 B of meta (offset, base, meta, s0).  A change to that layout needs the
count changed with it."""

import numpy as np


def window_words(layout, wins):
    """(u32 stream words, postings, windows) that the windows ``wins`` hold;
    pad windows (ids at or past ``n_windows``) hold none."""
    wins = np.asarray(wins).ravel()
    wins = wins[(wins >= 0) & (wins < layout.n_windows)]
    ln = layout.w_len[wins].astype(np.int64)
    dw = -(-ln * layout.w_dbits[wins].astype(np.int64) // 32)
    tw = -(-ln * layout.w_tfbits[wins].astype(np.int64) // 32)
    return int((dw + tw).sum()), int(ln.sum()), int(wins.size)
