"""``conv_roofline_pct``: the hand-written convs' share of their
roofline over one traced image.

Each conv launch the image makes (``yardstick.launches``) needs at the
least the larger of its operations at the TF32 peak and its bytes at
the HBM rate, whatever mode or kernel runs it: ``2 * n * h * w * 9 *
C_in * C_out`` operations; its input rows, the fp32 stencil and bias
(and, for the input gradient of a conv fused with its ReLU, the
mask) read once and its output written once. The share is the sum of those
least times over the summed device time of the kernels named below,
over every rank. Nothing is read unless every rank's kernels counted
(``LaunchCounter``) and the profiler saw exactly the launches worked
out from the shapes.
"""
from port_bench.yardstick.launches import image_launches
from port_bench.yardstick.peaks import FP32_BYTES, least_seconds

KERNELS = ("conv3x3_tc_kernel", "conv3x3_tf32_kernel", "conv3x3_ieee_kernel")


def least(conv) -> float:
    ops = 2 * conv.n * conv.h * conv.w * 9 * conv.c_in * conv.c_out
    words = (
        conv.n * conv.rows_in * conv.w * conv.c_in
        + 9 * conv.c_in * conv.c_out
        + (conv.c_out if conv.bias else 0)
        + (conv.n * conv.h * conv.w * conv.c_in if conv.mask else 0)
        + conv.n * conv.h * conv.w * conv.c_out
    )
    return least_seconds(ops, words * FP32_BYTES)


def read(view):
    need = spent = 0.0
    for entry in view.ranks:
        wanted, _ = image_launches(view.config, view.traffic, entry["rank"])
        seen, seconds = view.kernel_time(entry, KERNELS)
        if not seen or not seen == entry["counted"]["conv"] == len(wanted):
            return None
        need += sum(least(c) for c in wanted)
        spent += seconds
    return 100.0 * need / spent
