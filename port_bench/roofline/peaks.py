"""The published peaks of one NVIDIA H100 SXM that the cells' kernels run
against (NVIDIA's data sheet, dense, at its 700 W limit): float32 outside
the tensor cores, the rate of the cells' float32 products, and HBM3's
bandwidth."""

F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound(flop: float, nbytes: float) -> tuple:
    """(seconds, what bounds it): the larger of the operations over the
    float32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flop / F32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
