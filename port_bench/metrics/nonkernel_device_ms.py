"""``nonkernel_device_ms``: device milliseconds a step in every device
operation that is neither a conv or Gram kernel (the names below) nor
NCCL: the L-BFGS direction, its two hand-written kernels of
``csrc/lbfgs_ring.cu`` (``lbfgs_ring_products_kernel``,
``lbfgs_ring_combine_kernel``) included, the Gram backward, pooling,
elementwise passes, Adam, copies and sets. Over the traced image,
divided by its steps; on a mesh the worst rank's.
"""
PORT_KERNELS = (
    "conv3x3_tc_kernel", "conv3x3_tf32_kernel", "conv3x3_ieee_kernel",
    "gram_tc_kernel", "gram_tf32_kernel", "gram_ieee_kernel",
)
COLLECTIVES = ("nccl",)


def read(view):
    worst = None
    for entry in view.ranks:
        kernels = entry["summary"]["kernels"]
        if not kernels:
            return None
        total = sum(seconds for _, seconds in kernels.values())
        _, port = view.kernel_time(entry, PORT_KERNELS)
        _, nccl = view.kernel_time(entry, COLLECTIVES)
        ms = (total - port - nccl) * 1e3 / view.traced_steps
        worst = ms if worst is None else max(worst, ms)
    return worst
