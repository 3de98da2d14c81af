"""Fused in-range score accumulation (counterpart of ``ops/score_kernel.py``).

The hot inner op of Block-Max search: for each (query, candidate range)
row, gather each query term's posting window and sum every posting's
precomputed impact into its range-local slot.

On a CUDA tensor ``fused_range_scores`` launches the hand-written kernel
``csrc/score_kernel.cu``, which replaces both the TPU kernel
``vectorchord_bm25_tpu/ops/score_kernel.py::accumulate_rows`` (a one-hot
MXU matmul over 8-row groups) and the XLA window gather of the reference
``fused_range_scores``.  It is bound by memory traffic, not arithmetic:
about 5 B read per active posting lane (f32 impact + u8 slot) for one add,
and a 4*RS B f32 row written per (query, range).  On a CPU
tensor it runs ``fused_range_scores_plain``, the plain PyTorch version,
which the CPU tests hold against the Pallas kernel in interpret mode.

Exactness: inside one (term, range) group of a real index the slots are
unique, so each slot receives one impact per term and the terms add in
ascending t, in the kernel, in the plain version and in the one-hot
matmul alike.  The three agree bit for bit on index windows.
"""

from __future__ import annotations

import torch

__all__ = ["fused_range_scores", "fused_range_scores_plain"]

# Number of CUDA kernel launches since import (or since a caller reset it);
# chip_smoke.py reads it to show the main path went through the kernel.
LAUNCHES = 0

_MAX_RS = 256  # range-local ids are one byte (index/ranges.py)


def _check(post_impact, post_local, starts, lens, rs):
    if post_impact.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bf16 impacts are not ported yet (ROADMAP.md queue 2: "
            "impact_dtype='bfloat16')"
        )
    want = (
        (post_impact, torch.float32, "post_impact"),
        (post_local, torch.uint8, "post_local"),
        (starts, torch.int32, "starts"),
        (lens, torch.int32, "lens"),
    )
    for x, dtype, name in want:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != post_impact.device:
            raise ValueError(
                f"{name} is on {x.device}, post_impact on {post_impact.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if post_impact.dim() != 1 or post_local.shape != post_impact.shape:
        raise ValueError("post_impact and post_local must be equal-length 1-D")
    if starts.dim() != 3 or lens.shape != starts.shape:
        raise ValueError("starts and lens must both be [Q, T, C]")
    if not 1 <= rs <= _MAX_RS:
        raise ValueError(f"rs must be in [1, {_MAX_RS}], got {rs}")


def fused_range_scores_plain(post_impact, post_local, starts, lens, *, rs):
    """Plain PyTorch version: per term, gather the [Q, C, RS] windows, mask
    lanes at or past the window length, and scatter-add into the slots.
    A slot outside [0, RS) is dropped, as the one-hot matmul drops it."""
    q, t_terms, c = starts.shape
    lane = torch.arange(rs, dtype=torch.int32, device=starts.device)
    acc = torch.zeros((q, c, rs), dtype=torch.float32, device=starts.device)
    for t in range(t_terms):
        idx = starts[:, t, :, None] + lane  # [Q, C, RS]
        valid = lane < lens[:, t, :, None]
        idx = torch.where(valid, idx, 0).long()
        local = post_local[idx].long()
        valid &= local < rs
        imp = torch.where(valid, post_impact[idx], 0.0)
        acc.scatter_add_(2, torch.where(valid, local, 0), imp)
    return acc


def fused_range_scores(post_impact, post_local, starts, lens, *, rs: int):
    """[Q, C, RS] float32 per-(query, candidate, slot) scores.

    post_impact [P] f32, post_local [P] u8, starts/lens [Q, T, C] i32
    (lens 0 = inactive window).  A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version."""
    global LAUNCHES

    _check(post_impact, post_local, starts, lens, rs)
    if post_impact.device.type == "cpu":
        return fused_range_scores_plain(
            post_impact, post_local, starts, lens, rs=rs
        )
    if post_impact.device.type != "cuda":
        raise ValueError(f"unsupported device {post_impact.device}")

    from ._build import library

    lib = library()
    q, t_terms, c = starts.shape
    if q * c == 0:
        return torch.zeros((q, c, rs), dtype=torch.float32, device=starts.device)
    out = torch.empty((q, c, rs), dtype=torch.float32, device=starts.device)
    with torch.cuda.device(post_impact.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bm25_fused_range_scores(
            post_impact.data_ptr(),
            post_local.data_ptr(),
            starts.data_ptr(),
            lens.data_ptr(),
            out.data_ptr(),
            q,
            t_terms,
            c,
            rs,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_range_scores kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
