"""Feature taps and style/content losses (functions on tensors).

The port of the JAX package's ``models/features.py``. A tap at layer
index *i* is the activation *after* layer *i* runs. Every 3x3 conv
goes through ``ops.conv3x3`` (the kernel on CUDA) with the Pallas
sweep's fusion rule: a conv fuses with its ReLU only when the conv is
not a tap (style taps sample the PRE-ReLU conv output). Every Gram goes
through ``ops.gram``. Activations are ``(N, H, W, C)`` contiguous.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from style_transfer_visualizer_tpu_torch.models.arch import (
    CONV,
    RELU,
    LayerTable,
    layer_table_from_params,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import conv3x3_bias_relu
from style_transfer_visualizer_tpu_torch.ops.gram import gram_matrix
from style_transfer_visualizer_tpu_torch.ops.pool import maxpool_2x2, relu
from style_transfer_visualizer_tpu_torch.type_defs import InitMethod


@dataclass(frozen=True)
class Targets:
    """Precomputed optimization targets (no autograd history).

    ``style_grams`` maps layer index -> (C, C) Gram matrix of the style
    image; ``content_feats`` maps layer index -> raw activation of the
    content image.
    """

    style_grams: dict[int, torch.Tensor]
    content_feats: dict[int, torch.Tensor]


def _validate_layers(indices: tuple[int, ...], table: LayerTable) -> None:
    for idx in indices:
        if not 0 <= idx < len(table):
            msg = f"Layer index {idx} out of range 0..{len(table) - 1}"
            raise ValueError(msg)


def _conv(params: Params, idx: int, x: torch.Tensor, fuse: bool):
    layer = params[idx]
    return conv3x3_bias_relu(
        x, layer["w9"], layer["w9_flip"], layer["b"], fuse,
    )


def extract_features(
    params: Params,
    x: torch.Tensor,
    taps: tuple[int, ...],
) -> dict[int, torch.Tensor]:
    """Run the feature stack up to the deepest tap, recording activations.

    Layers beyond the last tap never run.
    """
    if not taps:
        return {}
    table = layer_table_from_params(params)
    _validate_layers(taps, table)
    tap_set = frozenset(taps)
    last = max(taps)
    acts: dict[int, torch.Tensor] = {}
    idx = 0
    while idx <= last:
        kind = table[idx][0]
        if kind == CONV:
            fuse = (
                idx + 1 <= last
                and table[idx + 1][0] == RELU
                and idx not in tap_set
            )
            x = _conv(params, idx, x, fuse)
            if fuse:
                idx += 1
        elif kind == RELU:
            x = relu(x)
        else:
            x = maxpool_2x2(x)
        if idx in tap_set:
            acts[idx] = x
        idx += 1
    return acts


@torch.no_grad()
def compute_targets(
    params: Params,
    style_img: torch.Tensor,
    content_img: torch.Tensor,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
) -> Targets:
    """Precompute style Gram targets and content activation targets."""
    style_acts = extract_features(params, style_img, style_layers)
    content_acts = extract_features(params, content_img, content_layers)
    return Targets(
        style_grams={
            idx: gram_matrix(act) for idx, act in style_acts.items()
        },
        content_feats=dict(content_acts),
    )


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def style_content_losses(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-layer style (Gram MSE) and content (feature MSE) losses."""
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    acts = extract_features(params, x, taps)
    style_losses = [
        _mse(gram_matrix(acts[idx]), targets.style_grams[idx])
        for idx in style_layers
    ]
    content_losses = [
        _mse(acts[idx], targets.content_feats[idx]) for idx in content_layers
    ]
    return style_losses, content_losses


def total_loss(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Weighted total loss plus (style_score, content_score).

    Empty layer lists contribute a zero scalar.
    """
    style_losses, content_losses = style_content_losses(
        params, x, targets, style_layers, content_layers,
    )
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    style_score = torch.stack(style_losses).sum() if style_losses else zero
    content_score = (
        torch.stack(content_losses).sum() if content_losses else zero
    )
    total = style_w * style_score + content_w * content_score
    return total, (style_score, content_score)


def initialize_input(
    content_img: torch.Tensor,
    method: InitMethod,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Build the optimization starting image.

    "content" clones the content image, "random" draws standard-normal
    noise from ``generator`` (on the content image's device), "white"
    is all ones.
    """
    if method == "content":
        return content_img.clone()
    if method == "random":
        if generator is None:
            msg = "random init requires a torch.Generator"
            raise ValueError(msg)
        return torch.randn(
            content_img.shape, generator=generator,
            dtype=content_img.dtype, device=content_img.device,
        )
    if method == "white":
        return torch.ones_like(content_img)
    msg = f"Unsupported initialization method: {method}"
    raise ValueError(msg)
