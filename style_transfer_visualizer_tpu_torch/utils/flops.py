"""Analytic matrix-math FLOPs of the optimization step.

The port of the JAX package's ``utils/flops.py``: it turns a measured
ms/step into achieved TFLOP/s and a share of the card's peak. It counts
the step's matrix math, which runs on the tensor cores and dominates
the device time (the convs and the Grams), and leaves out the
elementwise work (ReLU, pool, the optimizer, the losses), which is
bound by bytes and adds under 2% of the count at these shapes.

Counted, per step of one evaluation (one forward, one backward, one
update):

- forward 3x3 SAME convs up to the deepest tap:
  ``2 * h_l * w_l * 9 * C_in * C_out`` each (multiply and add);
- backward convs: the weights are frozen, so each conv's backward is
  one conv of the same cost on the flipped stencil (the input
  gradient only);
- per style tap, the Gram forward ``2 * P_l * C_l^2`` and the same
  again for its backward (``F S``).

The share of peak is against the H100 SXM's dense TF32 tensor-core
rate, 495 TFLOP/s at a 700 W power limit (NVIDIA's data sheet), at
every precision tier, as the JAX package quotes one peak at every
tier. In 3xTF32 (``high``) the kernels issue three TF32 products for
each counted operation, so a third of that peak (33.3%) is their
ceiling; in TF32 (``default``) the whole of it; in IEEE fp32
(``highest``) 67 TFLOP/s, 13.5%, so there the share is a lower bound
of how busy the units are.
"""
from __future__ import annotations

from style_transfer_visualizer_tpu_torch.models.arch import (
    CONV,
    LayerTable,
    pools_before_in,
)

#: H100 SXM dense TF32 tensor-core peak, TFLOP/s (NVIDIA's data sheet).
H100_TF32_PEAK_TFLOPS = 495.0


def conv_flops(
    table: LayerTable,
    height: int,
    width: int,
    max_tap: int,
) -> int:
    """Forward-conv FLOPs up to (and including) layer ``max_tap``."""
    total = 0
    for idx, (kind, c_in, c_out) in enumerate(table):
        if idx > max_tap:
            break
        if kind != CONV:
            continue
        scale = 2 ** pools_before_in(table, idx)
        h_l, w_l = height // scale, width // scale
        total += 2 * h_l * w_l * 9 * c_in * c_out
    return total


def gram_flops(
    table: LayerTable,
    height: int,
    width: int,
    style_layers: tuple[int, ...],
) -> int:
    """Forward Gram FLOPs across the style taps."""
    total = 0
    for idx in style_layers:
        scale = 2 ** pools_before_in(table, idx)
        pixels = (height // scale) * (width // scale)
        channels = table[idx][2]
        total += 2 * pixels * channels * channels
    return total


def step_flops(
    table: LayerTable,
    height: int,
    width: int,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
) -> int:
    """Analytic FLOPs of one forward + backward + update step.

    Forward and backward each cost one conv sweep (frozen weights: the
    backward of every conv is one flipped-stencil conv of the same
    shape), and each style Gram is contracted once forward and once
    in the backward.
    """
    max_tap = max((*style_layers, *content_layers))
    convs = conv_flops(table, height, width, max_tap)
    grams = gram_flops(table, height, width, style_layers)
    return 2 * convs + 2 * grams


def audit_fields(
    table: LayerTable,
    height: int,
    width: int,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    steps_per_sec: float,
) -> dict:
    """FLOPs per step, ms/step, achieved TFLOP/s and ``mfu_pct``, the
    share of the H100's dense TF32 peak in percent."""
    flops = step_flops(table, height, width, style_layers, content_layers)
    achieved = flops * steps_per_sec / 1e12
    return {
        "flops_per_step": flops,
        "ms_per_step": round(1000.0 / steps_per_sec, 3),
        "achieved_tflops": round(achieved, 2),
        "mfu_pct": round(100.0 * achieved / H100_TF32_PEAK_TFLOPS, 1),
    }
