"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at its 700 W limit), and a kernel's least time under them."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3, bytes/s


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
