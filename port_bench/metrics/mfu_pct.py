"""``mfu_pct``: the whole step's share of the cell's peak over one
traced image.

The frozen step FLOPs of the cell's family (its ``step_flops``; for
VGG ``yardstick.flops``, the port's ``utils/flops.py``) of every image
the cell holds, times the steps in the traced span, over the span's
wall time (the longest rank's) and the TF32 peak of the cell's chips.
It bounds every kernel's roofline from above: a kernel taken off the
path leaves its own share silent, not this one.
"""
from port_bench import families
from port_bench.yardstick.peaks import TF32_FLOPS


def read(view):
    if not view.ranks or not any(e["summary"]["kernels"] for e in view.ranks):
        return None
    height, width = view.traffic["content"]
    work = (
        families.load(view.config).step_flops(view.config, height, width)
        * len(view.traffic["styles"]) * view.traced_steps
    )
    span = max(e["summary"]["span_s"] for e in view.ranks)
    return 100.0 * work / (span * view.chips * TF32_FLOPS)
