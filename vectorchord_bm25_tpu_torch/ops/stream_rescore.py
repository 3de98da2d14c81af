"""Exact rescore of MaxScore candidates (counterpart of M4 ``_stream_rescore``).

MaxScore's phase 2 (``search/stream.py:366-431``): for each (query,
candidate doc) and each query term, binary-search the term's doc-ascending
window span for the last window whose base is <= the candidate, decode it,
and add the candidate's posting if it is there.  ``rescore_topk`` then
keeps the k best (score desc, doc asc), as the reference's sort does.

On a CUDA tensor ``stream_rescore`` (S5) launches ``csrc/stream_rescore.cu``;
on a CPU tensor it runs ``stream_rescore_plain``, the reference's search and
decode with the terms added in ascending order.  Kernel and plain version
add in the same order and agree bit for bit; the reference's ``jnp.sum``
over the terms has XLA's order, so against it the scores agree within a
few ulps and the ids exactly.
"""

from __future__ import annotations

import torch

from .stream_kernel import check_tables, check_tensors, unpack_and_score_plain
from .topk import lex_topk

__all__ = ["rescore_topk", "stream_rescore", "stream_rescore_plain"]

# Number of CUDA kernel launches of S5; chip_smoke.py reads it to show the
# main path went through the kernel.
LAUNCHES = 0


def stream_rescore_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs: int
):
    """Plain PyTorch version of ``stream_rescore``."""
    w_pad = w_off.shape[0] - 1
    span = int((t_hi - t_lo).max()) if t_lo.numel() else 0
    steps = max(span, 1).bit_length() + 1
    scores = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for t in range(t_lo.shape[1]):
        lo = t_lo[:, t : t + 1].expand_as(cand)
        l, r = lo, t_hi[:, t : t + 1].expand_as(cand)
        for _ in range(steps):
            m = (l + r) >> 1
            go = (m < r) & (w_base[m.clamp(max=w_pad).long()] <= cand)
            l = torch.where(go, m + 1, l)
            r = torch.where(go, r, m)
        wi = torch.where(l > lo, l - 1, w_pad).long()
        doc, sc = unpack_and_score_plain(
            words, s1_eff, w_off[wi], w_base[wi], w_meta[wi], w_s0[wi], n_docs
        )
        scores = scores + torch.where(doc == cand[..., None], sc, 0.0).sum(-1)
    keep = (cand < n_docs) & (scores > 0.0)
    return torch.where(keep, scores, float("-inf"))


def stream_rescore(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs: int
):
    """Exact scores of candidate docs.

    Tables as ``stream_dense_accumulate`` takes them; cand [Q, C] int32 doc
    ids (pad = n_docs); t_lo/t_hi [Q, T] int32 each query term's window span
    in the stream's doc-ascending order (pad terms: an empty span).  Returns
    [Q, C] f32: the sum over the terms, in ascending order, of the
    candidate's postings, or -inf unless the candidate is < n_docs and its
    sum > 0 (deleted and filtered docs score 0 through ``s1_eff``).  A CUDA
    tensor launches S5 or raises; a CPU tensor runs the plain version."""
    global LAUNCHES

    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, (
        (cand, torch.int32, "cand", 2),
        (t_lo, torch.int32, "t_lo", 2),
        (t_hi, torch.int32, "t_hi", 2),
    ))
    if t_lo.shape != t_hi.shape or t_lo.shape[0] != cand.shape[0]:
        raise ValueError(
            f"t_lo {tuple(t_lo.shape)} and t_hi {tuple(t_hi.shape)} must be "
            f"[Q, T] with cand's Q = {cand.shape[0]}"
        )
    if words.device.type == "cpu":
        return stream_rescore_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")

    from ._build import library

    lib = library()
    (q, c), t = cand.shape, t_lo.shape[1]
    out = torch.empty((q, c), dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        err = lib.bm25_stream_rescore(
            words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
            w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
            cand.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), out.data_ptr(),
            q, c, t, n_docs, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_rescore kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def rescore_topk(
    words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, k: int,
    n_docs: int,
):
    """The reference's ``_stream_rescore``: (scores [Q, k] f32 desc, ids
    [Q, k] int32), ties to the lower doc; -inf slots carry id 0."""
    scores = stream_rescore(
        words, s1_eff, w_off, w_base, w_meta, w_s0, cand, t_lo, t_hi, n_docs
    )
    kk = min(k, cand.shape[1])
    scores, ids = lex_topk(scores, cand, kk)
    ids = torch.where(torch.isfinite(scores), ids, 0)
    if kk < k:
        pad = k - kk
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=0)
    return scores, ids
