"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates), fixed for every precision mode.

Every roofline share and ``mfu_pct`` is taken against the TF32 rate,
whatever mode a kernel runs in, so that changing a kernel's mode or
implementation cannot move the yardstick. The ceiling of each mode
under it: 3xTF32 issues three TF32 products per counted operation,
so 33.3%; IEEE fp32 on the CUDA cores runs at 67 TFLOP/s, 13.5%.
"""
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
FP32_BYTES = 4


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for ``ops`` and ``nbytes``: the
    larger of the two bounds."""
    return max(ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
