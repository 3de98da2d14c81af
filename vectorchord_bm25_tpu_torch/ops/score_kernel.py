"""Fused in-range score accumulation (counterpart of ``ops/score_kernel.py``).

The hot inner op of Block-Max search: for each (query, candidate range)
row, gather each query term's posting window and sum every posting's
score into its range-local slot.  Two kernels:

- ``fused_range_scores`` (P1): precomputed impacts, f32 or bf16.  On a
  CUDA tensor it launches ``csrc/score_kernel.cu``, which replaces both the
  TPU kernel ``vectorchord_bm25_tpu/ops/score_kernel.py::accumulate_rows``
  (a one-hot MXU matmul over 8-row groups) and the XLA window gather of
  the reference ``fused_range_scores``, whose widening of bf16 impacts it
  keeps.  About 5 B read per active posting lane (3 B with bf16) for one
  add, and a 4*RS B f32 row written per (query, range): bound by memory
  traffic.  ``out`` lets a caller take the rows in a wider matrix (the
  exhaustive range sweep's accumulator).
- ``tf_range_scores`` (P1-tf): ``posting_mode="tf"``, where postings hold
  u8/u16 term frequencies and each score is rebuilt as
  ``tf*s0 / (tf + s1[fieldnorm[doc]])``.  On a CUDA tensor it launches
  ``csrc/tf_range_scores.cu``, which replaces the XLA scatter of the
  reference ``_blockmax_kernel`` in tf mode (``search/blockmax.py:169-182``).

On a CPU tensor each runs its plain PyTorch version, which the CPU tests
hold against the reference (the Pallas kernel in interpret mode, or the
reference's tf-mode scatter).

Exactness: inside one (term, range) group of a real index the slots are
unique, so each slot receives one score per term and the terms add in
ascending t, in the kernels, in the plain versions and in the reference
alike.  They agree bit for bit on index windows.
"""

from __future__ import annotations

import torch

__all__ = [
    "fused_range_scores",
    "fused_range_scores_plain",
    "tf_range_scores",
    "tf_range_scores_plain",
]

# Kernel launches since import (or since a caller reset them): P1 on f32
# impacts, P1 on bf16 impacts, and P1-tf.  chip_smoke.py reads them to show
# the main path went through the kernels.
LAUNCHES = 0
BF16_LAUNCHES = 0
TF_LAUNCHES = 0

_MAX_RS = 256  # range-local ids are one byte (index/ranges.py)


def _check_same(pairs, device):
    for x, dtypes, name in pairs:
        if x.dtype not in dtypes:
            want = " or ".join(str(d) for d in dtypes)
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_windows(post, post_local, starts, lens, rs):
    if post.dim() != 1 or post_local.shape != post.shape:
        raise ValueError("postings and post_local must be equal-length 1-D")
    if starts.dim() != 3 or lens.shape != starts.shape:
        raise ValueError("starts and lens must both be [Q, T, C]")
    if not 1 <= rs <= _MAX_RS:
        raise ValueError(f"rs must be in [1, {_MAX_RS}], got {rs}")


def _check(post_impact, post_local, starts, lens, rs, out):
    _check_same(
        (
            (post_impact, (torch.float32, torch.bfloat16), "post_impact"),
            (post_local, (torch.uint8,), "post_local"),
            (starts, (torch.int32,), "starts"),
            (lens, (torch.int32,), "lens"),
        ),
        post_impact.device,
    )
    _check_windows(post_impact, post_local, starts, lens, rs)
    if out is not None:
        q, _, c = starts.shape
        if (
            out.dtype != torch.float32
            or out.device != post_impact.device
            or tuple(out.shape) != (q, c * rs)
            or out.stride(1) != 1
        ):
            raise ValueError(
                f"out must be a float32 [Q, C*RS] = [{q}, {c * rs}] matrix "
                f"with unit column stride on {post_impact.device}"
            )


def fused_range_scores_plain(post_impact, post_local, starts, lens, *, rs, out=None):
    """Plain PyTorch version: per term, gather the [Q, C, RS] windows, mask
    lanes at or past the window length, widen the impacts to f32 and
    scatter-add them into the slots.  A slot outside [0, RS) is dropped, as
    the one-hot matmul drops it.  With ``out`` the rows are copied there."""
    q, t_terms, c = starts.shape
    lane = torch.arange(rs, dtype=torch.int32, device=starts.device)
    acc = torch.zeros((q, c, rs), dtype=torch.float32, device=starts.device)
    for t in range(t_terms):
        idx = starts[:, t, :, None] + lane  # [Q, C, RS]
        valid = lane < lens[:, t, :, None]
        idx = torch.where(valid, idx, 0).long()
        local = post_local[idx].long()
        valid &= local < rs
        imp = torch.where(valid, post_impact[idx].float(), 0.0)
        acc.scatter_add_(2, torch.where(valid, local, 0), imp)
    if out is None:
        return acc
    out.copy_(acc.reshape(q, c * rs))
    return out


def fused_range_scores(post_impact, post_local, starts, lens, *, rs: int, out=None):
    """[Q, C, RS] float32 per-(query, candidate, slot) scores.

    post_impact [P] f32 or bf16, post_local [P] u8, starts/lens [Q, T, C]
    i32 (lens 0 = inactive window).  ``out``, when given, is a float32
    ``[Q, C*RS]`` view (unit column stride, any row stride) that receives
    the rows and is returned instead.  A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version."""
    global LAUNCHES, BF16_LAUNCHES

    _check(post_impact, post_local, starts, lens, rs, out)
    if post_impact.device.type == "cpu":
        return fused_range_scores_plain(
            post_impact, post_local, starts, lens, rs=rs, out=out
        )
    if post_impact.device.type != "cuda":
        raise ValueError(f"unsupported device {post_impact.device}")

    from ._build import library

    lib = library()
    q, t_terms, c = starts.shape
    if out is None:
        result = torch.empty((q, c, rs), dtype=torch.float32, device=starts.device)
        target, row_stride = result, c * rs
    else:
        result = target = out
        row_stride = out.stride(0)
    if q * c == 0:
        return result.zero_()
    bf16 = post_impact.dtype == torch.bfloat16
    with torch.cuda.device(post_impact.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bm25_fused_range_scores(
            post_impact.data_ptr(),
            post_local.data_ptr(),
            starts.data_ptr(),
            lens.data_ptr(),
            target.data_ptr(),
            q,
            t_terms,
            c,
            rs,
            row_stride,
            int(bf16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_range_scores kernel launch failed: cudaError {err}")
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return result


def _check_tf(post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, starts, lens, rs):
    _check_same(
        (
            (post_tf, (torch.uint8, torch.int16), "post_tf"),
            (post_local, (torch.uint8,), "post_local"),
            (doc_fn, (torch.uint8,), "doc_fn"),
            (s1_table, (torch.float32,), "s1_table"),
            (q_s0, (torch.float32,), "q_s0"),
            (cand_r, (torch.int32,), "cand_r"),
            (starts, (torch.int32,), "starts"),
            (lens, (torch.int32,), "lens"),
        ),
        post_tf.device,
    )
    _check_windows(post_tf, post_local, starts, lens, rs)
    q, t_terms, c = starts.shape
    if tuple(q_s0.shape) != (q, t_terms) or tuple(cand_r.shape) != (q, c):
        raise ValueError("q_s0 must be [Q, T] and cand_r [Q, C]")
    if s1_table.shape != (256,) or doc_fn.dim() != 1:
        raise ValueError("s1_table must be [256] and doc_fn 1-D")


def tf_range_scores_plain(
    post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, starts, lens, *,
    rs, n_docs,
):
    """Plain PyTorch version, the reference's tf-mode scatter
    (``search/blockmax.py:166-192``) statement for statement: every lane of
    every window scores ``(tf*s0) / (tf + s1[fn[min(doc, n_docs)]])`` with
    tf = 0 past the window's length, and adds into its slot in ascending t.
    Like the reference's gather, a window start past the postings reads the
    last one; slots outside [0, RS) are dropped, as its scatter drops them.
    ``post_tf`` is u8, or int16 holding u16 bits."""
    q, t_terms, c = starts.shape
    dev = starts.device
    lane = torch.arange(rs, dtype=torch.int32, device=dev)
    acc = torch.zeros((q, c, rs), dtype=torch.float32, device=dev)
    last = post_local.numel() - 1
    base = cand_r[:, :, None].long() * rs  # [Q, C, 1]
    s1_of = s1_table[doc_fn.long()]  # [N+1] f32: s1 of each doc's fieldnorm
    for t in range(t_terms):
        idx = (starts[:, t, :, None] + lane).long().clamp_max(last)  # [Q, C, RS]
        valid = lane < lens[:, t, :, None]
        local = post_local[idx].long()
        tf = post_tf[idx].int() & 0xFFFF
        tval = torch.where(valid, tf.float(), 0.0)
        s1 = s1_of[(base + local).clamp_max(n_docs)]
        sc = (tval * q_s0[:, t, None, None]) / (tval + s1)
        keep = local < rs
        acc.scatter_add_(2, torch.where(keep, local, 0), torch.where(keep, sc, 0.0))
    return acc


def tf_range_scores(
    post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, starts, lens, *,
    rs: int, n_docs: int,
):
    """[Q, C, RS] float32 scores rebuilt from term frequencies.

    post_tf [P] u8 (or int16 holding u16 bits), post_local [P] u8, doc_fn
    [N+1] u8 fieldnorms (pad doc ``n_docs``), s1_table [256] f32, q_s0
    [Q, T] f32 per-term s0 (0 for the null term), cand_r [Q, C] i32
    candidate ranges, starts/lens [Q, T, C] i32.  A CUDA tensor launches
    the kernel or raises; a CPU tensor runs the plain version."""
    global TF_LAUNCHES

    _check_tf(post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, starts, lens, rs)
    args = (post_tf, post_local, doc_fn, s1_table, q_s0, cand_r, starts, lens)
    if post_tf.device.type == "cpu":
        return tf_range_scores_plain(*args, rs=rs, n_docs=n_docs)
    if post_tf.device.type != "cuda":
        raise ValueError(f"unsupported device {post_tf.device}")

    from ._build import library

    lib = library()
    q, t_terms, c = starts.shape
    out = torch.empty((q, c, rs), dtype=torch.float32, device=starts.device)
    if q * c == 0:
        return out
    with torch.cuda.device(post_tf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bm25_tf_range_scores(
            *(x.data_ptr() for x in args),
            out.data_ptr(),
            q,
            t_terms,
            c,
            rs,
            n_docs,
            int(post_tf.dtype == torch.int16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"tf_range_scores kernel launch failed: cudaError {err}")
    TF_LAUNCHES += 1
    return out
