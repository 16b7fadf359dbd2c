"""The VGG family (``vgg19``, ``vgg16``): a configuration's ``cfg`` of
3x3 convs, each followed by a ReLU, and ``"M"`` pools (torchvision's
layer numbering), run to the deepest tap. The port's hand-written
kernels on this path are the 3x3 conv and the Gram.
"""
from __future__ import annotations

import torch

from port_bench.generate import weights_seed
from port_bench.reference.objective import CONV, Objective, layer_table
from port_bench.yardstick import flops


def make_weights(
    config: dict, seed: int, device: torch.device,
) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
    """He-normal ``(3, 3, C_in, C_out)`` kernels and small biases for
    every conv up to the deepest tap, drawn on ``device`` in one call."""
    table = layer_table(config["cfg"])
    last = max(*config["style_layers"], *config["content_layers"])
    convs = [
        (idx, c_in, c_out)
        for idx, (kind, c_in, c_out) in enumerate(table[: last + 1])
        if kind == CONV
    ]
    sizes = [n for _, ci, co in convs for n in (9 * ci * co, co)]
    gen = torch.Generator(device=device).manual_seed(weights_seed(seed))
    draws = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(torch.split(draws, sizes))
    weights = {}
    for idx, c_in, c_out in convs:
        w = next(parts).reshape(3, 3, c_in, c_out) * (2.0 / (9 * c_in)) ** 0.5
        b = next(parts) * config["bias_std"]
        weights[idx] = (w, b)
    return weights


def port_params(config: dict, weights: dict, device: torch.device) -> dict:  # noqa: ARG001
    """Each conv's stencil ``(9, C_in, C_out)``, its flip for the input
    gradient, both packed K-major as tf32 ``(hi, lo)``, and its bias:
    the layout the port's conv kernels read."""
    from style_transfer_visualizer_tpu_torch.models.vgg19 import (  # noqa: PLC0415
        flip_stencil,
        pack_stencil,
    )

    params = {}
    for idx, (w, b) in weights.items():
        w9 = w.reshape(9, w.shape[2], w.shape[3]).contiguous()
        w9_flip = flip_stencil(w9)
        wk_hi, wk_lo = pack_stencil(w9)
        wkf_hi, wkf_lo = pack_stencil(w9_flip)
        params[idx] = {
            "w9": w9, "w9_flip": w9_flip, "b": b, "wk_hi": wk_hi,
            "wk_lo": wk_lo, "wkf_hi": wkf_hi, "wkf_lo": wkf_lo,
        }
    return params


def objective(
    config: dict, weights: dict, content: torch.Tensor, style: torch.Tensor,
) -> Objective:
    """The reference's Gatys objective over the weights in OIHW."""
    oihw = {
        idx: (w.permute(3, 2, 0, 1).contiguous(), b)
        for idx, (w, b) in weights.items()
    }
    return Objective(config, oihw, content, style)


def launch_counters() -> dict:
    from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram  # noqa: PLC0415

    return {"conv": conv3x3.launches, "gram": gram.launches}


def step_flops(config: dict, height: int, width: int) -> int:
    return flops.step_flops(config, height, width)
