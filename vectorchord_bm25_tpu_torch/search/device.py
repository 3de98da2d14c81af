"""Device-resident view of a sealed segment (counterpart of ``search/device.py``).

The same layout as the reference, as torch tensors on an explicit device:

- doc slot ``n_docs`` is the pad doc (dead);
- posting row ``n_rows`` is the pad row (all pad docs, impact 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..index.sealed import BLOCK, SealedSegment

from ..utils.device import as_device

__all__ = ["DeviceSegment", "live_mask"]


def live_mask(n_docs: int, deleted: Optional[np.ndarray]) -> np.ndarray:
    """[N+1] float32: 1.0 live, 0.0 deleted or pad."""
    live = np.ones(n_docs + 1, dtype=np.float32)
    live[n_docs] = 0.0
    if deleted is not None:
        live[:n_docs] = np.where(deleted[:n_docs], 0.0, 1.0)
    return live


@dataclass
class DeviceSegment:
    """torch views of one sealed segment."""

    n_docs: int
    n_tokens: int
    n_rows: int  # posting rows (128 lanes each), excluding the pad row

    doc_live: torch.Tensor  # [N+1] float32 (1.0 live, 0.0 deleted/pad)
    post_docid: torch.Tensor  # [R+1, 128] int32 flat postings (pad = N)
    post_impact: torch.Tensor  # [R+1, 128] f32/bf16 precomputed scores (pad = 0)
    token_flat_start: Optional[np.ndarray] = None  # host [V+1] int64 CSR
    host: SealedSegment = None

    @classmethod
    def from_sealed(
        cls,
        seg: SealedSegment,
        deleted: Optional[np.ndarray] = None,
        device="cuda",
        with_blocks: bool = True,
        impact_dtype: str = "float32",
    ) -> "DeviceSegment":
        """with_blocks=False skips uploading the posting rows (the pruned
        engine reads its own compact flat postings instead).
        impact_dtype="bfloat16" drops impact memory to 2 B/posting at
        ~0.4% relative score rounding (rank ties may reorder)."""
        dev = as_device(device)
        n = seg.n_docs
        if with_blocks:
            docid, impact, csr = seg.flat_impact_postings()
            total = docid.size
            rows = -(-max(total, 1) // BLOCK)
            pd = np.full(((rows + 1) * BLOCK,), n, dtype=np.int32)
            pi = np.zeros(((rows + 1) * BLOCK,), dtype=np.float32)
            pd[:total] = docid
            pi[:total] = impact
        else:
            rows, csr = 0, None
            pd = np.full(BLOCK, n, dtype=np.int32)
            pi = np.zeros(BLOCK, dtype=np.float32)
        impact = torch.from_numpy(pi.reshape(rows + 1, BLOCK)).to(dev)
        if impact_dtype == "bfloat16":
            # Round to nearest even, as the reference's jnp cast does.
            impact = impact.to(torch.bfloat16)
        return cls(
            n_docs=n,
            n_tokens=seg.n_tokens,
            n_rows=rows,
            doc_live=torch.from_numpy(live_mask(n, deleted)).to(dev),
            post_docid=torch.from_numpy(pd.reshape(rows + 1, BLOCK)).to(dev),
            post_impact=impact,
            token_flat_start=csr,
            host=seg,
        )

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Refresh the live mask after deletes (bitmap consulted at scoring)."""
        self.doc_live = torch.from_numpy(live_mask(self.n_docs, deleted)).to(
            self.doc_live.device
        )
