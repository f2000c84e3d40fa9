"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

PEAK_FLOPS = {"float32": FP32_FLOPS, "tf32": TF32_FLOPS, "bf16": BF16_FLOPS}


def bound_s(flops: float, nbytes: float, precision: str = "float32") -> float:
    """The least time the chip could take: the larger of the operations over
    the peak rate of `precision` and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)
