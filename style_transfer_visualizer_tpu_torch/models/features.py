"""Feature taps and style/content losses (functions on tensors).

The port of the JAX package's ``models/features.py``. A tap at layer
index *i* is the activation *after* layer *i* runs. Every 3x3 conv
goes through ``ops.conv3x3`` (the kernel on CUDA) with the Pallas
sweep's fusion rule: a conv fuses with its ReLU only when the conv is
not a tap (style taps sample the PRE-ReLU conv output). Every Gram goes
through ``ops.gram``. Activations are ``(N, H, W, C)`` contiguous.

The multi-style batch (:func:`batched_total_loss`) runs S independent
problems through one sweep: the conv at N = S, one Gram launch per
style layer for all S images (``ops.gram.gram_matrix_batched``), and
per-style losses, ``(S,)`` each.

``remat=True`` (``extract_features`` and every loss built on it)
cuts the sweep into segments that end at each tap and each pool and
runs each under ``torch.utils.checkpoint``, as the JAX package's
``jax.checkpoint`` segments: the same values, bit for bit, for one
more forward. Banded evaluation lives in ``ops/tiled.py``.

Every function takes ``precision``, a level or a policy
(``ops/precision.py``), as the JAX package's do: each conv runs its
forward at ``conv_precision(precision, idx)`` and its backward at
``conv_bwd_precision``, each Gram at ``gram_precision`` and
``gram_bwd_precision``. Unset, it is the pipeline default, ``MIXED``.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from style_transfer_visualizer_tpu_torch.models.arch import (
    CONV,
    POOL,
    RELU,
    LayerTable,
    layer_table_from_params,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.conv3x3 import conv3x3_bias_relu
from style_transfer_visualizer_tpu_torch.ops.gram import (
    gram_matrix,
    gram_matrix_batched,
)
from style_transfer_visualizer_tpu_torch.ops.pool import maxpool_2x2, relu
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MIXED,
    PrecisionLike,
    conv_bwd_precision,
    conv_precision,
    kernel_mode,
)
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


def blend_targets(
    targets_seq: list[Targets],
    weights: list[float],
) -> Targets:
    """Weighted blend of style Gram targets (multi-style interpolation).

    A convex combination of per-style Grams is the target of a style
    mixture. Content targets come from the first entry; every entry was
    computed against the same content image, and the style-only extras
    (``content_layers=()``) carry none.
    """
    if len(targets_seq) != len(weights) or not targets_seq:
        msg = "blend_targets needs one weight per Targets entry"
        raise ValueError(msg)
    grams: dict[int, torch.Tensor] = {}
    for idx in targets_seq[0].style_grams:
        acc = weights[0] * targets_seq[0].style_grams[idx]
        for t, w in zip(targets_seq[1:], weights[1:], strict=True):
            acc = acc + w * t.style_grams[idx]
        grams[idx] = acc.detach()
    return Targets(
        style_grams=grams,
        content_feats=targets_seq[0].content_feats,
    )


def targets_maybe_blended(
    one_targets: Callable[[torch.Tensor, tuple[int, ...]], Targets],
    style_img: torch.Tensor,
    content_layers: tuple[int, ...],
    blend_imgs: list[tuple[torch.Tensor, float]] | None,
) -> Targets:
    """Single-style targets, or the weighted multi-style Gram blend.

    ``one_targets(style_image, content_layers)`` is the caller's own
    target computation (full resolution or a coarse level). A blend
    calls it with the content layers for the first style and with none
    (``()``, no content sweep) for the rest, then mixes the Grams by
    weight (:func:`blend_targets`).
    """
    if blend_imgs is None:
        return one_targets(style_img, content_layers)
    first = one_targets(blend_imgs[0][0], content_layers)
    extras = [one_targets(img, ()) for img, _ in blend_imgs[1:]]
    return blend_targets(
        [first, *extras], [weight for _, weight in blend_imgs],
    )


def _validate_layers(indices: tuple[int, ...], table: LayerTable) -> None:
    for idx in indices:
        if not 0 <= idx < len(table):
            msg = f"Layer index {idx} out of range 0..{len(table) - 1}"
            raise ValueError(msg)


def _conv(
    params: Params, idx: int, x: torch.Tensor, fuse: bool,
    precision: PrecisionLike,
):
    layer = params[idx]
    return conv3x3_bias_relu(
        x, layer["w9"], layer["w9_flip"], layer["b"], fuse,
        (layer["wk_hi"], layer["wk_lo"]), (layer["wkf_hi"], layer["wkf_lo"]),
        mode=kernel_mode(conv_precision(precision, idx)),
        bwd_mode=kernel_mode(conv_bwd_precision(precision, idx)),
    )


def _sweep(
    params: Params,
    x: torch.Tensor,
    layers: range,
    tap_set: frozenset[int],
    last: int,
    precision: PrecisionLike,
    table: LayerTable,
) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
    """Run ``layers`` of the stack on ``x``; the output and its taps.

    A conv fuses with its ReLU when the conv is not a tap and the ReLU
    runs (``idx + 1 <= last``). A remat segment ends at a tap or a
    pool, so a fused pair never straddles two segments: a segmented
    sweep launches the same kernels as a whole one.
    """
    acts: dict[int, torch.Tensor] = {}
    idx = layers.start
    while idx < layers.stop:
        kind = table[idx][0]
        if kind == CONV:
            fuse = (
                idx + 1 <= last
                and table[idx + 1][0] == RELU
                and idx not in tap_set
            )
            x = _conv(params, idx, x, fuse, precision)
            if fuse:
                idx += 1
        elif kind == RELU:
            x = relu(x)
        else:
            x = maxpool_2x2(x)
        if idx in tap_set:
            acts[idx] = x
        idx += 1
    return x, acts


def extract_features(
    params: Params,
    x: torch.Tensor,
    taps: tuple[int, ...],
    precision: PrecisionLike = MIXED,
    *,
    remat: bool = False,
) -> dict[int, torch.Tensor]:
    """Run the feature stack up to the deepest tap, recording activations.

    Layers beyond the last tap never run; each conv runs at its level
    of ``precision``.

    With ``remat=True`` (and autograd recording) the stack is cut into
    segments that end at every tap and every pool, as the JAX package
    cuts it, and each segment runs under ``torch.utils.checkpoint``:
    the backward recomputes a segment's inner activations instead of
    keeping them, about one more forward for the memory. The same
    deterministic kernels recompute the same values, so the losses and
    the gradient are those of ``remat=False`` bit for bit.
    """
    if not taps:
        return {}
    table = layer_table_from_params(params)
    _validate_layers(taps, table)
    tap_set = frozenset(taps)
    last = max(taps)
    if not (remat and torch.is_grad_enabled()):
        _, acts = _sweep(
            params, x, range(last + 1), tap_set, last, precision, table,
        )
        return acts
    acts: dict[int, torch.Tensor] = {}
    start = 0
    for idx in range(last + 1):
        if idx in tap_set or table[idx][0] == POOL:
            # No random numbers are drawn, so no RNG state is kept
            # (fetching it is not allowed while a CUDA graph captures).
            x, seg_acts = checkpoint(
                _sweep, params, x, range(start, idx + 1), tap_set, last,
                precision, table, use_reentrant=False,
                preserve_rng_state=False,
            )
            acts.update(seg_acts)
            start = idx + 1
    return acts


@torch.no_grad()
def compute_targets(
    params: Params,
    style_img: torch.Tensor,
    content_img: torch.Tensor,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    precision: PrecisionLike = MIXED,
) -> Targets:
    """Precompute style Gram targets and content activation targets."""
    style_acts = extract_features(params, style_img, style_layers, precision)
    content_acts = extract_features(
        params, content_img, content_layers, precision,
    )
    return Targets(
        style_grams={
            idx: gram_matrix(act, precision=precision)
            for idx, act in style_acts.items()
        },
        content_feats=dict(content_acts),
    )


@torch.no_grad()
def compute_content_targets(
    params: Params,
    content_img: torch.Tensor,
    content_layers: tuple[int, ...],
    precision: PrecisionLike = MIXED,
) -> dict[int, torch.Tensor]:
    """Content activation targets only (the style Grams are unchanged).

    The frame sequence's per-frame targets: its style Grams are
    computed once for the clip, its content targets for every frame.
    """
    return dict(
        extract_features(params, content_img, content_layers, precision),
    )


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _resolve_style_weights(
    style_weights: tuple[float, ...] | None,
    style_layers: tuple[int, ...],
) -> tuple[float, ...]:
    """Validated per-layer style weights (all 1.0 when unset)."""
    if style_weights is None:
        return (1.0,) * len(style_layers)
    if len(style_weights) != len(style_layers):
        msg = (
            f"style_weights has {len(style_weights)} entries for "
            f"{len(style_layers)} style layers"
        )
        raise ValueError(msg)
    return tuple(float(w) for w in style_weights)


def _weighted(w: float, term: torch.Tensor) -> torch.Tensor:
    """``w * term``; a weight of 1.0 leaves the term as it is.

    So the default weights give the unweighted loss bit for bit.
    """
    return term if w == 1.0 else w * term


def style_content_losses(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = MIXED,
    *,
    remat: bool = False,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-layer style (Gram MSE) and content (feature MSE) losses.

    ``style_weights`` scales each style layer's Gram MSE, one weight
    per entry of ``style_layers``; ``None`` weighs every layer 1.0.
    ``remat`` rematerializes the feature sweep (:func:`extract_features`).
    """
    weights = _resolve_style_weights(style_weights, style_layers)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    acts = extract_features(params, x, taps, precision, remat=remat)
    style_losses = [
        _weighted(
            w,
            _mse(
                gram_matrix(acts[idx], precision=precision),
                targets.style_grams[idx],
            ),
        )
        for idx, w in zip(style_layers, weights, strict=True)
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
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = MIXED,
    *,
    remat: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Weighted total loss plus (style_score, content_score).

    Empty layer lists contribute a zero scalar; ``style_weights`` and
    ``remat`` as in :func:`style_content_losses`.
    """
    style_losses, content_losses = style_content_losses(
        params, x, targets, style_layers, content_layers, style_weights,
        precision, remat=remat,
    )
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    style_score = torch.stack(style_losses).sum() if style_losses else zero
    content_score = (
        torch.stack(content_losses).sum() if content_losses else zero
    )
    total = style_w * style_score + content_w * content_score
    return total, (style_score, content_score)


def _mse_per_image(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of each leading-axis entry: ``(S,)``.

    ``b`` may be a broadcast view (stride 0 on the leading axis): the
    difference broadcasts, nothing is copied.
    """
    return torch.mean(torch.square(a - b), dim=tuple(range(1, a.dim())))


def batched_style_content_losses(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = MIXED,
    *,
    remat: bool = False,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-layer style and content losses of S images, each ``(S,)``.

    ``x`` is ``(S, H, W, 3)``, one image per style. ``targets`` holds
    ``(S, C, C)`` style Grams and ``(S, 1, h, w, C)`` content features
    (a broadcast of the one content's, see
    ``parallel.multistyle.multi_style_targets``). Image s is held to
    style s's Grams only, as under the JAX package's ``vmap``.
    ``remat`` as in :func:`extract_features`.
    """
    weights = _resolve_style_weights(style_weights, style_layers)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    acts = extract_features(params, x, taps, precision, remat=remat)
    style_losses = [
        _weighted(
            w,
            _mse_per_image(
                gram_matrix_batched(acts[idx], precision=precision),
                targets.style_grams[idx],
            ),
        )
        for idx, w in zip(style_layers, weights, strict=True)
    ]
    content_losses = [
        _mse_per_image(acts[idx], targets.content_feats[idx][:, 0])
        for idx in content_layers
    ]
    return style_losses, content_losses


def batched_total_loss(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = MIXED,
    *,
    remat: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """:func:`total_loss` of each of S images: ``(S,)`` each.

    The S problems are independent, so the gradient of the sum is each
    image's gradient of its own loss; ``remat`` as in
    :func:`extract_features`.
    """
    style_losses, content_losses = batched_style_content_losses(
        params, x, targets, style_layers, content_layers, style_weights,
        precision, remat=remat,
    )
    zero = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    style_score = (
        torch.stack(style_losses).sum(dim=0) if style_losses else zero
    )
    content_score = (
        torch.stack(content_losses).sum(dim=0) if content_losses else zero
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
