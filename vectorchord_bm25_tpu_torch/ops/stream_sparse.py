"""The stream engine's sparse reduction (counterpart of M3 ``_stream_sparse``).

``stream_sparse_topk`` is the reference's ``_stream_sparse``
(``search/stream.py:309-363``): for a ``[Q, P]`` matrix of window ids it
decodes and scores every lane, sorts each row by doc, sums each doc's run
and keeps the k best run sums, ties to the lower doc.  Its steps:

1. ``stream_sparse_decode`` (S3): every ``[Q, P*128]`` lane as (doc, score),
   dead and pad lanes as ``(n_docs, 0.0)``;
2. ``torch.sort(stable=True)`` of each row by doc, the scores gathered
   along: within a run the lanes stay in window order, which is term order;
3. ``sparse_combine`` (S4): the reference's Hillis-Steele run sums, and at
   each run's last lane the packed selection key of ``ops/topk.py::_pack``;
4. ``select_keys``: the k smallest keys per row, as ``lex_topk`` selects.

On a CUDA tensor S3 and S4 launch ``csrc/stream_sparse.cu``; on a CPU
tensor they run their plain versions, ``stream_sparse_decode_plain`` (the
reference's M1 through ``unpack_and_score_plain``) and
``sparse_combine_plain`` (the reference's scan, line for line).  Kernel,
plain version and reference agree bit for bit.
"""

from __future__ import annotations

import torch

from .stream_kernel import WINDOW, check_tables, check_tensors, unpack_and_score_plain
from .topk import _pack, select_keys

__all__ = [
    "sparse_combine",
    "sparse_combine_plain",
    "sparse_lanes_topk",
    "stream_sparse_decode",
    "stream_sparse_decode_plain",
    "stream_sparse_topk",
]

# Number of CUDA kernel launches of S3 and of S4; chip_smoke.py reads them to
# show the main path went through the kernels.
DECODE_LAUNCHES = 0
COMBINE_LAUNCHES = 0

# The scan's depth bound (csrc/stream_sparse.cu keeps its partial sums in a
# register stack of this depth).
MAX_SEG_STEPS = 30


def stream_sparse_decode_plain(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs: int):
    """Plain PyTorch version of ``stream_sparse_decode``."""
    q, p = wsrc.shape
    ws = wsrc.long()
    doc, sc = unpack_and_score_plain(
        words, s1_eff, w_off[ws], w_base[ws], w_meta[ws], w_s0[ws], n_docs
    )
    return doc.reshape(q, p * WINDOW), sc.reshape(q, p * WINDOW)


def stream_sparse_decode(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs: int):
    """Decode and score every lane of a ``[Q, P]`` window-id matrix.

    Tables as ``stream_dense_accumulate`` takes them; wsrc [Q, P] int32
    (pad: the zero-length window W).  Returns (doc [Q, P*128] int32, sc
    [Q, P*128] f32): live lanes their doc and ``(tf*s0)/(tf + s1_eff[doc])``,
    dead lanes ``n_docs`` and the same expression at tf = 1 (0.0, since
    ``s1_eff[n_docs]`` is +inf).  A CUDA tensor launches S3 or raises; a CPU
    tensor runs the plain version."""
    global DECODE_LAUNCHES

    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, ((wsrc, torch.int32, "wsrc", 2),))
    if words.device.type == "cpu":
        return stream_sparse_decode_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    q, p = wsrc.shape
    if q * p >= (1 << 31) // WINDOW:
        raise ValueError(f"{q * p} windows exceed the kernel's int32 lane index")

    from ._build import library

    lib = library()
    dev = words.device
    doc = torch.empty((q, p * WINDOW), dtype=torch.int32, device=dev)
    sc = torch.empty((q, p * WINDOW), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bm25_stream_sparse_decode(
            words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
            w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
            wsrc.data_ptr(), doc.data_ptr(), sc.data_ptr(), q * p, n_docs,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_sparse_decode kernel launch failed: cudaError {err}")
    DECODE_LAUNCHES += 1
    return doc, sc


def sparse_combine_plain(df, sf, n_docs: int, seg_steps: int):
    """Plain PyTorch version of ``sparse_combine``: the reference's scan
    (``search/stream.py:339-353``), then ``_pack``."""
    q = df.shape[0]
    s = sf
    for i in range(seg_steps):
        sh = 1 << i
        zero_i = torch.zeros((q, sh), dtype=df.dtype, device=df.device)
        zero_f = torch.zeros((q, sh), dtype=s.dtype, device=s.device)
        same = torch.cat([zero_i == 1, df[:, sh:] == df[:, :-sh]], dim=1)
        add = torch.cat([zero_f, s[:, :-sh]], dim=1)
        s = s + torch.where(same, add, 0.0)
    is_last = torch.cat(
        [df[:, :-1] != df[:, 1:], torch.ones((q, 1), dtype=torch.bool, device=df.device)],
        dim=1,
    )
    cand = torch.where(is_last & (df < n_docs) & (s > 0.0), s, float("-inf"))
    return _pack(cand, df)


def sparse_combine(df, sf, n_docs: int, seg_steps: int):
    """Packed selection keys of doc-sorted lanes.

    df [Q, L] int32, each row ascending (a stable sort of
    ``stream_sparse_decode``'s docs), sf [Q, L] f32 their scores; seg_steps
    >= bit_length(longest run - 1).  Returns keys [Q, L] int64: at the last
    lane of each run with doc < n_docs and run sum > 0 the ``_pack`` key of
    (sum, doc), elsewhere the pad key of (-inf, doc).  A CUDA tensor
    launches S4 or raises; a CPU tensor runs the plain version."""
    global COMBINE_LAUNCHES

    check_tensors(df, ((df, torch.int32, "df", 2), (sf, torch.float32, "sf", 2)))
    if df.shape != sf.shape or df.shape[1] < 1:
        raise ValueError(f"df {tuple(df.shape)} and sf {tuple(sf.shape)} must match, L >= 1")
    if not 0 <= seg_steps <= MAX_SEG_STEPS:
        raise ValueError(f"seg_steps must be in [0, {MAX_SEG_STEPS}], got {seg_steps}")
    if df.device.type == "cpu":
        return sparse_combine_plain(df, sf, n_docs, seg_steps)
    if df.device.type != "cuda":
        raise ValueError(f"unsupported device {df.device}")

    from ._build import library

    lib = library()
    q, lanes = df.shape
    keys = torch.empty((q, lanes), dtype=torch.int64, device=df.device)
    with torch.cuda.device(df.device):
        err = lib.bm25_sparse_combine(
            df.data_ptr(), sf.data_ptr(), keys.data_ptr(), q * lanes, lanes,
            n_docs, seg_steps, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sparse_combine kernel launch failed: cudaError {err}")
    COMBINE_LAUNCHES += 1
    return keys


def sparse_lanes_topk(doc, sc, k: int, n_docs: int, seg_steps: int):
    """(scores [Q, k] f32 desc, ids [Q, k] int32) of each row's run sums
    over its ``[Q, L]`` (doc, score) lanes, dead lanes ``(n_docs, 0.0)``:
    the stable sort by doc, S4 and the selection.  Rows with fewer than k
    candidates pad with -inf, whose ids follow the reference (the lowest
    docs of the row's other lanes, then 0 past its lanes) and mean nothing.
    Shared by the stream engine's and the exact engine's sparse strategies."""
    df, perm = torch.sort(doc, dim=1, stable=True)
    sf = sc.gather(1, perm)
    del perm
    keys = sparse_combine(df, sf, n_docs, seg_steps)
    del df, sf
    kk = min(k, keys.shape[1])
    scores, ids = select_keys(keys, kk)
    del keys
    if kk < k:
        pad = k - kk
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=0)
    return scores, ids


def stream_sparse_topk(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, k: int, n_docs: int,
    seg_steps: int,
):
    """The reference's ``_stream_sparse``: S3's lanes through
    ``sparse_lanes_topk``."""
    doc, sc = stream_sparse_decode(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, n_docs)
    return sparse_lanes_topk(doc, sc, k, n_docs, seg_steps)
