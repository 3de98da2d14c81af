"""Window decompress, score and scatter (counterpart of M1 + M2 in ``search/stream.py``).

The stream engine's dense path: every gathered window of the compressed
posting stream (``index/stream.py``) is decoded into 128 lanes of
(doc, tf), each posting is scored as ``(tf * s0) / (tf + s1_eff[doc])``
in f32, and the score is added into its query's row of a dense
``[n_q, N+1]`` accumulator.

On a CUDA tensor ``stream_dense_accumulate`` launches the hand-written
kernel ``csrc/stream_dense.cu`` once, which fuses the reference's
``_unpack_and_score`` (``search/stream.py:171-266``) with the zero-fill
and the scatter-add of ``_stream_dense`` (``:296-303``): a block sums one
doc tile of one query's row in shared memory and writes it once
(``csrc/dense_tiles.cuh``, stated in ``ops/dense_tiles.py``), so the
accumulator is allocated uninitialised and written cell by cell exactly
once.  On a CPU tensor it runs ``stream_dense_accumulate_plain``, built on
``unpack_and_score_plain``, the plain PyTorch twin of M1.

The windows come in the planning's order (``search/stream.py::
_layout``: query-major, term-major, a term's windows consecutive and
doc-ascending) with each query's span and each window's term ordinal.

Exactness.  The reference's scatter-add adds each (query, doc)'s terms in
window order, which is term order inside a query.  Both versions add one
term ordinal at a time, in ascending order: inside one ordinal a (query,
doc) is hit at most once (a term's postings are unique per doc), so the
kernel's plain read-add-write in shared memory is race-free, and across
ordinals the adds land in the reference's order.  A span off the
planning's layout (``stream_spans_in_layout``) is served by the kernel
one lane at a time, in that order.  Kernel, plain version and reference
agree bit for bit.

Storage types: the stream words (u32 on the host) are uploaded as int32
and the u16 window meta as int16 (every meta value is below 2^15), since
torch covers unsigned 16/32-bit types thinly.  The plain version masks
after every shift, so the arithmetic shift of a negative word is harmless.
"""

from __future__ import annotations

import torch

from . import dense_tiles
from .dense_tiles import PAD, lists_in_layout, span_windows
from .topk import new_accumulator

__all__ = [
    "stream_dense_accumulate",
    "stream_dense_accumulate_plain",
    "stream_spans_in_layout",
    "unpack_and_score_plain",
]

# Number of CUDA kernel launches (one a dispatch); chip_smoke.py reads it
# to show the main path went through the kernel.
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


def stream_dense_accumulate_plain(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord,
    n_q: int, n_docs: int,
):
    """Plain PyTorch version of ``stream_dense_accumulate``: per term
    ordinal in ascending order, decode and score the windows of the spans
    that carry it and add the lanes into their query's row (dead lanes add
    0.0 to the pad column)."""
    acc = new_accumulator(n_q, n_docs, words.device)
    stride = acc.stride(0)
    flat = acc.as_strided((n_q * stride,), (1,))  # the padded rows, flat
    entry, query = span_windows(q_start, wsrc.numel())
    ords = w_ord[entry]
    for o in torch.unique(ords[ords >= 0]).tolist():  # ascending
        sel = ords == o
        ws = wsrc[entry[sel]].long()
        doc, sc = unpack_and_score_plain(
            words, s1_eff, w_off[ws], w_base[ws], w_meta[ws], w_s0[ws], n_docs
        )
        idx = query[sel][:, None] * stride + doc.long()
        flat.index_add_(0, idx.reshape(-1), sc.reshape(-1))
    return acc


def stream_spans_in_layout(wsrc, q_start, w_ord, w_base):
    """[n_q] bool: whether each query's span keeps the layout S1's tile
    walk relies on (``ops/dense_tiles.py``): ordinals (< 0: a pad)
    non-decreasing with pads last, and inside one ordinal the windows'
    first docs ``w_base[wsrc]`` strictly rising.  The kernel serves any
    other span one lane at a time, in the reference's order."""
    entry, query = span_windows(q_start, wsrc.numel())
    o = w_ord[entry]
    key = torch.where(o >= 0, o, PAD)
    first = w_base[wsrc[entry].long()]
    return lists_in_layout(key, first, torch.zeros_like(o, dtype=torch.bool), query, q_start.numel() - 1)


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


def _check(words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord, n_q, n_docs):
    check_tables(words, s1_eff, w_off, w_base, w_meta, w_s0, n_docs)
    check_tensors(words, (
        (wsrc, torch.int32, "wsrc", 1),
        (q_start, torch.int32, "q_start", 1),
        (w_ord, torch.int32, "w_ord", 1),
    ))
    if w_ord.numel() != wsrc.numel():
        raise ValueError(f"w_ord has {w_ord.numel()} entries, wsrc {wsrc.numel()}")
    if n_q < 1:
        raise ValueError(f"n_q must be >= 1, got {n_q}")
    if q_start.numel() != n_q + 1:
        raise ValueError(f"q_start has {q_start.numel()} entries, need n_q + 1 = {n_q + 1}")


def stream_dense_accumulate(
    words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord,
    n_q: int, n_docs: int,
):
    """``[n_q, n_docs + 1]`` f32 accumulator of every window's scores.

    words [S] int32 stream; s1_eff [N+1] f32; w_off/w_base [W+1] int32,
    w_meta [W+1] int16, w_s0 [W+1] f32 (entry W: the zero-length pad
    window); wsrc [T] int32 window ids in the planning's order; q_start
    [n_q + 1] int32, query q's span ``[q_start[q], q_start[q + 1])`` of
    wsrc (windows outside every span add nothing); w_ord [T] int32, each
    window's term ordinal inside its query (< 0: a pad, which adds
    nothing).  The result is a row view of a 16-B-aligned allocation
    (``ops.topk.new_accumulator``).  A CUDA tensor launches the kernel once
    (it writes every cell: the accumulator is not zero-filled first) or
    raises; a CPU tensor runs the plain version."""
    global LAUNCHES

    args = (words, s1_eff, w_off, w_base, w_meta, w_s0, wsrc, q_start, w_ord, n_q, n_docs)
    _check(*args)
    if words.device.type == "cpu":
        return stream_dense_accumulate_plain(*args)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")

    from ._build import library

    lib = library()
    dev = words.device
    acc = new_accumulator(n_q, n_docs, dev, zero=False)
    with torch.cuda.device(dev):
        err = lib.bm25_stream_dense_accumulate(
            words.data_ptr(), s1_eff.data_ptr(), w_off.data_ptr(),
            w_base.data_ptr(), w_meta.data_ptr(), w_s0.data_ptr(),
            wsrc.data_ptr(), q_start.data_ptr(), w_ord.data_ptr(),
            acc.data_ptr(), wsrc.numel(), acc.stride(0), n_q, n_docs,
            dense_tiles.TILE, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream_dense_accumulate kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return acc
