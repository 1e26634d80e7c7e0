"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): the denominators of every roofline and mfu
share.  The port scores in fp32 with TF32 off, so fp32 outside the tensor
cores is its compute peak."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(n_bytes: float, n_flops: float = 0.0) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory's rate and operations over fp32's."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S)
