"""``gram_roofline_pct``: the hand-written Gram forward's share of its
roofline over one traced image.

A Gram launch over ``images`` blocks of ``P`` pixels by ``C`` channels
needs at the least ``images * P * C * (C + 1)`` operations (the
symmetric product's upper triangle, multiply and add) and reads each
block once and writes one ``C`` x ``C`` result per image, in fp32. The
share, the kernels' matching and the count checks are
``conv_roofline_pct``'s. The Gram's backward is a library product and
falls under ``nonkernel_device_ms``.
"""
from port_bench.yardstick.launches import image_launches
from port_bench.yardstick.peaks import FP32_BYTES, least_seconds

KERNELS = ("gram_tc_kernel", "gram_tf32_kernel", "gram_ieee_kernel")


def least(gram) -> float:
    ops = gram.images * gram.pixels * gram.channels * (gram.channels + 1)
    words = gram.images * (gram.pixels * gram.channels + gram.channels**2)
    return least_seconds(ops, words * FP32_BYTES)


def read(view):
    need = spent = 0.0
    for entry in view.ranks:
        _, wanted = image_launches(view.config, view.traffic, entry["rank"])
        seen, seconds = view.kernel_time(entry, KERNELS)
        if not seen or not seen == entry["counted"]["gram"] == len(wanted):
            return None
        need += sum(least(g) for g in wanted)
        spent += seconds
    return 100.0 * need / spent
