"""Equal-index-memory accounting vs the reference's on-disk block format
(the port's copy of ``vectorchord_bm25_tpu/utils/memparity.py``; numpy
only, it takes any port engine's ``memory_report()``).

The reference extension stores postings as 128-entry blocks: doc ids are
delta-coded from the block minimum and bit-packed, term frequencies are
bit-packed plain, and partial (<128) blocks are byte-packed over only
their live entries, each side prefixed with one metadata byte
(the extension's crates/bm25/src/compression.rs:36-136,
tuples.rs:973-1069).  Around the blocks sit fixed-size tuples:

- SummaryTuple per block: min/max doc id (2x u32), n_docs u8,
  wand_fieldnorm u8, wand_tf u32, wptr (u32,u16) -> 20 B, 8-byte aligned
  to 24 B (tuples.rs:900-971);
- TokenTuple per term: id [u8;16], df u32, wand pair u8+u32,
  wptr (u32,u16) -> 31 B, aligned to 32 B (tuples.rs:833-898);
- DocumentTuple per doc: deleted u8 + fieldnorm u8 + payload [u16;3]
  = 8 B (tuples.rs:756-831).

`reference_format_bytes` computes that layout's size for one of our
sealed segments so engines can report memory *parity* — their
device-resident bytes against what the reference would spend on the same
postings.  Page headers, address trees, and free space are excluded
(they favor us, so the comparison stays conservative).
"""

from __future__ import annotations

import numpy as np

from ..index.sealed import BLOCK, SealedSegment

__all__ = ["reference_format_bytes", "memory_parity_report"]


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Per-element bit length of non-negative int64 (0 -> 0 bits).

    log2(x + 1) is exact at the power-of-two boundaries in float64 for
    x < 2^53, so ceil gives the bit count without per-element Python.
    """
    x = np.asarray(x, dtype=np.int64)
    return np.ceil(np.log2(x.astype(np.float64) + 1.0)).astype(np.int64)


def reference_format_bytes(seg: SealedSegment) -> dict:
    """Bytes the reference's sealed-segment format would use for `seg`."""
    b = seg.n_blocks
    out = {
        "blocks": 0,
        "summaries": 24 * b,
        "tokens": 32 * seg.n_tokens,
        "documents": 8 * seg.n_docs,
    }
    if b:
        n = seg.block_n.astype(np.int64)
        slot = np.arange(BLOCK, dtype=np.int64)[None, :]
        valid = slot < n[:, None]

        d = seg.block_docids.astype(np.int64)
        base = seg.block_min_doc.astype(np.int64)
        prev = np.concatenate([base[:, None], d[:, :-1]], axis=1)
        delta = np.where(valid, d - prev, 0)
        doc_bits = _bit_length(delta.max(axis=1))
        tf_bits = _bit_length(
            np.where(valid, seg.block_tfs.astype(np.int64), 0).max(axis=1)
        )

        full = n == BLOCK
        # Full blocks: 128 values at w bits = 16*w bytes per side
        # (compression.rs:36-51); partial: n values at ceil(w/8) bytes
        # (compression.rs:52-62); +1 metadata byte per side.
        full_bytes = 16 * (doc_bits[full] + tf_bits[full])
        part_n = n[~full]
        part_bytes = part_n * (
            (doc_bits[~full] + 7) // 8 + (tf_bits[~full] + 7) // 8
        )
        out["blocks"] = int(full_bytes.sum() + part_bytes.sum() + 2 * b)
    out["total"] = sum(out.values())
    postings = int(seg.block_n.sum())
    out["postings"] = postings
    out["bytes_per_posting"] = (
        (out["blocks"] + out["summaries"]) / postings if postings else 0.0
    )
    return out


def memory_parity_report(engine, seg: SealedSegment) -> dict:
    """One engine's device bytes against the reference format for the
    same segment (the equal-index-memory check, BASELINE.md)."""
    ours = engine.memory_report()
    ref = reference_format_bytes(seg)
    return {
        "device_bytes": ours["total"],
        "device_bytes_per_posting": round(ours["bytes_per_posting"], 3),
        "reference_bytes": ref["total"],
        "reference_bytes_per_posting": round(ref["bytes_per_posting"], 3),
        "ratio_vs_reference": round(ours["total"] / max(1, ref["total"]), 3),
    }
