"""The card's published peaks: NVIDIA H100 SXM data sheet, dense rates
without sparsity, at the full 700 W power limit."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the bf16 tensor peak and the bytes over the HBM bandwidth."""
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
