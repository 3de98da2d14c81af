"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): a kernel's least time is taken
against them.  A card whose ``power.limit`` reads lower runs slower under
load; the run prints the limit beside every share."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
POWER_LIMIT_W = 700.0


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds for work that moves ``n_bytes`` of device memory
    and does ``n_ops`` float32 operations: the larger of the two times."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
