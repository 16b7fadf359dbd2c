"""Matrix-math FLOPs of one optimizer step, from the shapes.

A frozen copy of the port's ``utils/flops.py`` (``conv_flops``,
``gram_flops``, ``step_flops``) over the layer table of a
configuration file. One step is one forward sweep to the deepest tap,
one input-gradient conv per forward conv (the weights are frozen) and
one Gram per style tap forward and again backward:
``2 * convs + 2 * grams``, with ``2 * h * w * 9 * C_in * C_out`` per
conv and ``2 * P * C^2`` per Gram.
"""
from __future__ import annotations

from port_bench.reference.objective import CONV, POOL, layer_table


def pools_before_in(table, idx: int) -> int:
    return sum(1 for j, row in enumerate(table) if j <= idx and row[0] == POOL)


def conv_flops(table, height: int, width: int, max_tap: int) -> int:
    total = 0
    for idx, (kind, c_in, c_out) in enumerate(table):
        if idx > max_tap:
            break
        if kind != CONV:
            continue
        scale = 2 ** pools_before_in(table, idx)
        total += 2 * (height // scale) * (width // scale) * 9 * c_in * c_out
    return total


def gram_flops(table, height: int, width: int, style_layers) -> int:
    total = 0
    for idx in style_layers:
        scale = 2 ** pools_before_in(table, idx)
        pixels = (height // scale) * (width // scale)
        total += 2 * pixels * table[idx][2] ** 2
    return total


def step_flops(config: dict, height: int, width: int) -> int:
    """FLOPs of one step of one image of ``height`` x ``width``."""
    table = layer_table(config["cfg"])
    style, content = config["style_layers"], config["content_layers"]
    max_tap = max(*style, *content)
    return 2 * conv_flops(table, height, width, max_tap) + 2 * gram_flops(
        table, height, width, style,
    )
