"""Window decompress, score and scatter (counterpart of M1 + M2 in ``search/stream.py``).

The stream engine's dense path: every gathered window of the compressed
posting stream (``index/stream.py``) is decoded into 128 lanes of
(doc, tf), each posting is scored as ``(tf * s0) / (tf + s1_eff[doc])``
in f32, and the score is added into its query's row of a dense
``[n_q, N+1]`` accumulator.

On a CUDA tensor ``stream_dense_accumulate`` launches the hand-written
kernel ``csrc/stream_dense.cu``, which fuses the reference's
``_unpack_and_score`` (``search/stream.py:171-266``) with the scatter-add
of ``_stream_dense`` (``:296-303``): decoded lanes live in registers and
only the accumulator is written.  On a CPU tensor it runs
``stream_dense_accumulate_plain``, built on ``unpack_and_score_plain``,
the plain PyTorch twin of M1.

Exactness.  The reference's scatter-add adds each (query, doc)'s terms in
window order, which is term order inside a query.  Here the windows are
launched one term ordinal at a time, in ascending order: inside one
ordinal a (query, doc) is hit at most once (a term's postings are unique
per doc), so a plain read-add-write is race-free, and across ordinals the
adds land in the reference's order.  Kernel, plain version and reference
agree bit for bit.

Storage types: the stream words (u32 on the host) are uploaded as int32
and the u16 window meta as int16 (every meta value is below 2^15), since
torch covers unsigned 16/32-bit types thinly.  The plain version masks
after every shift, so the arithmetic shift of a negative word is harmless.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import new_accumulator

__all__ = [
    "stream_dense_accumulate",
    "stream_dense_accumulate_plain",
    "unpack_and_score_plain",
]

# Number of CUDA kernel launches (one per term ordinal of a dispatch);
# chip_smoke.py reads it to show the main path went through the kernel.
LAUNCHES = 0

WINDOW = 128  # lanes per window (index/stream.py)


def unpack_and_score_plain(
    words, s1_eff, win_off, win_base, win_meta, win_s0, n_docs: int
):
    """Decompress windows and score every posting (the twin of M1).

    words [S] int32, s1_eff [N+1] f32 (+inf = deleted/filtered/pad),
    win_off/win_base [...] int32, win_meta [...] int16 (len | dclass<<8 |
    tclass<<10), win_s0 [...] f32.  Returns (doc [..., 128] int32 with
    dead lanes = n_docs, sc [..., 128] f32 with dead, deleted and filtered
    lanes = 0.0)."""
    dev = words.device
    lane = torch.arange(WINDOW, dtype=torch.int32, device=dev)
    meta = win_meta.to(torch.int32) & 0xFFFF
    length = meta & 0xFF
    dbits = 2 << ((meta >> 8) & 3)
    tclass = (meta >> 10) & 7
    tfbits = torch.where(tclass == 0, 0, 1 << tclass)
    live = lane < length[..., None]
    off = win_off.to(torch.int32)

    def extract(first_word, bits, valid):
        # Lane l's value sits at bit l*bits; widths divide 32, so it never
        # straddles two words.
        pos = lane * bits[..., None]
        idx = torch.where(valid, first_word[..., None] + (pos >> 5), 0)
        word = words[idx.long()]
        return (word >> (pos & 31)) & ((1 << bits) - 1)[..., None]

    delta = extract(off, dbits, live)
    delta = torch.where(live & (lane > 0), delta, 0)
    doc = win_base[..., None] + torch.cumsum(delta, dim=-1, dtype=torch.int32)
    doc = torch.where(live, doc, n_docs)

    # The window's tf words follow its doc words in the stream.
    has_tf = live & (tfbits > 0)[..., None]
    toff = off + ((length * dbits + 31) >> 5)
    tf = torch.where(has_tf, extract(toff, tfbits, has_tf), 1).to(torch.float32)

    # Dead lanes carry doc = n_docs whose s1_eff is +inf: exactly 0.0.
    sc = (tf * win_s0[..., None]) / (tf + s1_eff[doc.long()])
    return doc, sc


def _ordinal_groups(word_ord, t: int):
    """Host (order, bounds): a stable permutation grouping the windows by
    term ordinal, ascending, and the [n_ord + 1] group bounds in it."""
    ords = np.asarray(word_ord, dtype=np.int64).reshape(-1)
    if ords.size != t:
        raise ValueError(f"word_ord has {ords.size} entries, wsrc {t}")
    if t and int(ords.min()) < 0:
        raise ValueError("word_ord must be >= 0")
    order = np.argsort(ords, kind="stable")
    counts = np.bincount(ords, minlength=1) if t else np.zeros(1, np.int64)
    bounds = np.concatenate(([0], np.cumsum(counts)))
    return order, bounds


def stream_dense_accumulate_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, wq, word_ord,
    n_q: int, n_docs: int,
):
    """Plain PyTorch version of ``stream_dense_accumulate``: per term
    ordinal in ascending order, decode and score its windows and add the
    lanes into the accumulator (dead lanes add 0.0 to the pad column)."""
    acc = new_accumulator(n_q, n_docs, words.device)
    stride = acc.stride(0)
    flat = acc.as_strided((n_q * stride,), (1,))  # the padded rows, flat
    order, bounds = _ordinal_groups(word_ord, wsrc.numel())
    order = torch.from_numpy(order).to(wsrc.device)
    for o in range(bounds.size - 1):
        sel = order[int(bounds[o]) : int(bounds[o + 1])]
        if sel.numel() == 0:
            continue
        ws = wsrc[sel].long()
        doc, sc = unpack_and_score_plain(
            words, s1_eff, w_off[ws], w_base[ws], w_meta[ws], w_s0[ws], n_docs
        )
        idx = wq[sel].long()[:, None] * stride + doc.long()
        flat.index_add_(0, idx.reshape(-1), sc.reshape(-1))
    return acc


def check_tensors(words, want) -> None:
    """Raise unless each (tensor, dtype, name, dims) of ``want`` has that
    dtype and number of dims, lies on ``words``' device and is contiguous."""
    for x, dtype, name, dims in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != words.device:
            raise ValueError(f"{name} is on {x.device}, words on {words.device}")
        if x.dim() != dims:
            raise ValueError(f"{name} must be {dims}-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs: int) -> None:
    """The engine's stream tables, as every stream kernel takes them."""
    check_tensors(words, (
        (words, torch.int32, "words", 1),
        (s1_eff, torch.float32, "s1_eff", 1),
        (w_off, torch.int32, "w_off", 1),
        (w_base, torch.int32, "w_base", 1),
        (w_meta, torch.int16, "w_meta", 1),
        (w_s0, torch.float32, "w_s0", 1),
    ))
    if s1_eff.numel() != n_docs + 1:
        raise ValueError(f"s1_eff has {s1_eff.numel()} entries, need {n_docs + 1}")
    n_win = w_off.numel()
    if not (w_base.numel() == w_meta.numel() == w_s0.numel() == n_win):
        raise ValueError("w_off, w_base, w_meta and w_s0 must be equal length")


def _check(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, wq, n_q, n_docs):
    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, ((wsrc, torch.int32, "wsrc", 1), (wq, torch.int32, "wq", 1)))
    if wq.numel() != wsrc.numel():
        raise ValueError("wsrc and wq must be equal length")
    if n_q < 1:
        raise ValueError(f"n_q must be >= 1, got {n_q}")


def stream_dense_accumulate(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, wq, word_ord,
    n_q: int, n_docs: int,
):
    """``[n_q, n_docs + 1]`` f32 accumulator of every window's scores.

    words [S] int32 stream; s1_eff [N+1] f32; w_off/w_base [W+1] int32,
    w_meta [W+1] int16, w_s0 [W+1] f32 (entry W: the zero-length pad
    window); wsrc/wq [T] int32 window ids and their query rows (< n_q);
    word_ord [T] host ints, each window's term ordinal inside its query.
    The result is a row view of a 16-B-aligned allocation
    (``ops.topk.new_accumulator``).  A CUDA tensor launches the kernel
    once per ordinal, ascending, or raises; a CPU tensor runs the plain
    version."""
    global LAUNCHES

    _check(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, wq, n_q, n_docs)
    if isinstance(word_ord, torch.Tensor) and word_ord.device.type != "cpu":
        raise ValueError("word_ord is host data: pass a numpy array or a CPU tensor")
    if words.device.type == "cpu":
        return stream_dense_accumulate_plain(
            words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, wq, word_ord,
            n_q, n_docs,
        )
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")

    from ._build import library

    lib = library()
    dev = words.device
    t = wsrc.numel()
    order, bounds = _ordinal_groups(word_ord, t)
    if t and np.any(order != np.arange(t)):
        perm = torch.from_numpy(order).to(dev)
        wsrc, wq = wsrc[perm], wq[perm]
    acc = new_accumulator(n_q, n_docs, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for o in range(bounds.size - 1):
            lo, hi = int(bounds[o]), int(bounds[o + 1])
            if hi == lo:
                continue
            err = lib.bm25_stream_dense_accumulate(
                words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
                w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
                wsrc.data_ptr() + 4 * lo, wq.data_ptr() + 4 * lo,
                acc.data_ptr(), hi - lo, acc.stride(0), n_q, n_docs, stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"stream_dense_accumulate kernel launch failed: cudaError {err}"
                )
            LAUNCHES += 1
    return acc
