"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), the yardstick of every roofline share here. A card set
below 700 W runs slower under load: each run prints the card's limit."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; an FMA counts as two


def bound_s(ops: float, bytes_moved: float) -> float:
    """The least time the card could take for `ops` float32 operations and
    `bytes_moved` bytes of HBM traffic."""
    return max(ops / F32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S)
