"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
BF16_FLOP_PER_S = 989e12  # tensor cores, dense


def least_s(flops: float = 0.0, nbytes: float = 0.0,
            flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """The least time the card needs for the work: the larger of its
    operations over the peak rate and its bytes over HBM bandwidth."""
    return max(flops / flop_per_s, nbytes / HBM_BYTES_PER_S)
