"""Banded (row-tiled) feature extraction and loss for large content.

The port of the JAX package's ``ops/tiled.py``. The Gram matrix and the
content MSE are sums over pixels, so the whole image's loss is a sum
over horizontal row bands: each band slices its rows plus a
receptive-field margin on each side, runs the VGG stack on that
window, and adds its raw (unclamped, undivided) C x C Gram partials and
squared-error sums to the totals. The clamp and the normalization
apply once, to the totals: the whole-image loss's order (clamp before
normalize).

Why bands with margins are exact: a stack of 3x3 SAME convolutions
corrupts at most ``r`` rows inward from an artificial cut, ``r`` the
receptive-field radius (one row per conv at that conv's pooling
scale). Each window keeps a margin ``>= r`` on every cut edge and is
clamped so that a window at the image's border cuts exactly at the
global edge, where zero padding is the whole image's own. Window starts
stay multiples of ``2^pools`` so the max-pool grids align.

The bands run one after another in a Python loop; the band offsets are
Python ints and every window has the same height, so the convs and
Grams of every band launch at the same shapes and one captured CUDA
graph holds them all. Each band of the objective runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of the
band): the forward keeps only its partials, and the backward recomputes
one band at a time, so no band's activations outlive it. Every conv
and Gram goes through the kernels on the card (``ops/conv3x3.py``,
``ops/gram.gram_raw``) and through their plain versions on the CPU.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
    MAX_BAND_PIXELS,
)
from style_transfer_visualizer_tpu_torch.models.arch import (
    CONV,
    VGG19,
    LayerTable,
    layer_table_from_params,
    pools_before_in,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    _mse,
    _resolve_style_weights,
    _weighted,
    compute_targets,
    extract_features,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import Params
from style_transfer_visualizer_tpu_torch.ops.gram import gram_raw
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MIXED,
    PrecisionLike,
)

LAYER_TABLE = VGG19.layer_table


def round_up(value: int, multiple: int) -> int:
    """Round ``value`` up to the next multiple of ``multiple``."""
    return ((value + multiple - 1) // multiple) * multiple


def receptive_margin(
    taps: tuple[int, ...],
    table: LayerTable = LAYER_TABLE,
) -> tuple[int, int]:
    """(margin_rows, align) for exact band tiling of the given taps.

    ``margin_rows`` is the receptive-field radius of the deepest tap in
    input rows (each 3x3 conv adds one row of context per side at its
    own pooling scale), rounded up to ``align = 2^pools`` so window
    starts stay on the global pooling grid. ``table`` selects the
    architecture's layer layout (VGG19 by default).
    """
    if not taps:
        return 0, 1
    last = max(taps)
    radius = sum(
        2 ** pools_before_in(table, idx)
        for idx, (kind, _, _) in enumerate(table[: last + 1])
        if kind == CONV
    )
    align = 2 ** pools_before_in(table, last)
    return round_up(radius, align), align


def validate_tiling(
    global_h: int,
    tile_rows: int,
    taps: tuple[int, ...],
    table: LayerTable = LAYER_TABLE,
) -> None:
    """Check that ``tile_rows`` produces an exact, aligned band tiling."""
    margin, align = receptive_margin(taps, table)
    if tile_rows % align != 0 or global_h % align != 0:
        msg = (
            f"Tiled evaluation needs tile_rows ({tile_rows}) and image "
            f"height ({global_h}) divisible by 2^pools = {align} so "
            f"pooling grids align across bands."
        )
        raise ValueError(msg)
    if global_h % tile_rows != 0:
        msg = (
            f"Image height ({global_h}) must be divisible by tile_rows "
            f"({tile_rows})."
        )
        raise ValueError(msg)
    if tile_rows + 2 * margin > global_h:
        msg = (
            f"tile_rows ({tile_rows}) + 2 x margin ({margin}) exceeds the "
            f"image height ({global_h}); use whole-image evaluation "
            f"instead of tiling."
        )
        raise ValueError(msg)


def auto_tile_rows(
    global_h: int,
    global_w: int,
    taps: tuple[int, ...],
    *,
    max_band_pixels: int = MAX_BAND_PIXELS,
    table: LayerTable = LAYER_TABLE,
) -> int | None:
    """Pick a band height for auto-tiling, or None if none fits.

    Chooses the largest valid ``tile_rows`` whose *window* (band plus
    margins) stays within ``max_band_pixels``; fewer bands recompute
    fewer margin rows. The default budget is the H100's
    (``constants.MAX_BAND_PIXELS``); the JAX package's is 3,500,000.
    """
    margin, align = receptive_margin(taps, table)
    for n_tiles in range(2, 65):
        if global_h % n_tiles != 0:
            continue
        tile_rows = global_h // n_tiles
        if tile_rows % align != 0 or tile_rows + 2 * margin > global_h:
            continue
        if (tile_rows + 2 * margin) * global_w <= max_band_pixels:
            return tile_rows
    return None


def band_windows(
    global_h: int, tile_rows: int, margin: int,
) -> list[tuple[int, int]]:
    """``(window start, valid offset)`` of each band, top to bottom.

    A window is ``tile_rows + 2 * margin`` rows, its start clamped into
    the image; the band's own rows begin ``valid offset`` rows into it.
    """
    window_h = tile_rows + 2 * margin
    out = []
    for i in range(global_h // tile_rows):
        start = min(max(i * tile_rows - margin, 0), global_h - window_h)
        out.append((start, i * tile_rows - start))
    return out


def _raw_band_partials(
    params: Params,
    x: torch.Tensor,
    window: tuple[int, int],
    window_h: int,
    tile_rows: int,
    content_feats: dict[int, torch.Tensor],
    tile_index: int,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    precision: PrecisionLike,
) -> tuple[dict[int, torch.Tensor], dict[int, torch.Tensor]]:
    """One band's raw Gram partials and content squared-error sums.

    ``window`` is the band's ``(start, valid offset)``; ``tile_index``
    locates the band's rows of the global content targets.
    """
    start, valid_offset = window
    table = layer_table_from_params(params)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    acts = extract_features(
        params, x[:, start:start + window_h], taps, precision,
    )
    grams: dict[int, torch.Tensor] = {}
    content_sq: dict[int, torch.Tensor] = {}
    for idx in taps:
        scale = 2 ** pools_before_in(table, idx)
        rows = tile_rows // scale
        lo = valid_offset // scale
        valid = acts[idx][:, lo:lo + rows]
        if idx in style_layers:
            grams[idx] = gram_raw(valid, precision)
        if idx in content_layers:
            target = content_feats[idx][
                :, tile_index * rows:(tile_index + 1) * rows
            ]
            content_sq[idx] = torch.sum(torch.square(valid - target))
    return grams, content_sq


def _accumulate(total: dict | None, part: dict) -> dict:
    if total is None:
        return part
    return {k: total[k] + part[k] for k in total}


def tiled_style_content_losses(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    *,
    tile_rows: int,
    precision: PrecisionLike = MIXED,
    style_weights: tuple[float, ...] | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-layer losses computed band by band; exact against the whole.

    With autograd recording, each band runs under
    ``torch.utils.checkpoint`` (no RNG state: nothing here draws random
    numbers, and fetching it is not allowed while a CUDA graph
    captures), so the backward replays one band at a time instead of
    keeping every band's activations.
    """
    table = layer_table_from_params(params)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    b, gh, gw, _ = x.shape
    validate_tiling(int(gh), tile_rows, taps, table)
    margin, _ = receptive_margin(taps, table)
    window_h = tile_rows + 2 * margin
    grams_raw: dict | None = None
    content_sq: dict | None = None
    for i, window in enumerate(band_windows(int(gh), tile_rows, margin)):
        args = (
            params, x, window, window_h, tile_rows, targets.content_feats,
            i, style_layers, content_layers, precision,
        )
        if torch.is_grad_enabled():
            grams, sq = checkpoint(
                _raw_band_partials, *args, use_reentrant=False,
                preserve_rng_state=False,
            )
        else:
            grams, sq = _raw_band_partials(*args)
        grams_raw = _accumulate(grams_raw, grams)
        content_sq = _accumulate(content_sq, sq)

    weights = _resolve_style_weights(style_weights, style_layers)
    style_losses = []
    for idx, w in zip(style_layers, weights, strict=True):
        scale = 2 ** pools_before_in(table, idx)
        n_norm = b * (gh // scale) * (gw // scale) * table[idx][2]
        gram = torch.clamp(grams_raw[idx], max=GRAM_MATRIX_CLAMP_MAX) / n_norm
        style_losses.append(_weighted(w, _mse(gram, targets.style_grams[idx])))
    content_losses = []
    for idx in content_layers:
        scale = 2 ** pools_before_in(table, idx)
        n_elems = b * (gh // scale) * (gw // scale) * table[idx][2]
        content_losses.append(content_sq[idx] / n_elems)
    return style_losses, content_losses


def tiled_total_loss(
    params: Params,
    x: torch.Tensor,
    targets: Targets,
    style_w: float,
    content_w: float,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    tile_rows: int,
    precision: PrecisionLike = MIXED,
    style_weights: tuple[float, ...] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Weighted total loss via band tiling; the contract of
    ``models.features.total_loss``."""
    style_losses, content_losses = tiled_style_content_losses(
        params, x, targets, style_layers, content_layers,
        tile_rows=tile_rows, precision=precision,
        style_weights=style_weights,
    )
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    style_score = torch.stack(style_losses).sum() if style_losses else zero
    content_score = (
        torch.stack(content_losses).sum() if content_losses else zero
    )
    total = style_w * style_score + content_w * content_score
    return total, (style_score, content_score)


def _tiled_style_grams(
    params: Params,
    style_img: torch.Tensor,
    style_layers: tuple[int, ...],
    tile_rows: int,
    precision: PrecisionLike,
) -> dict[int, torch.Tensor]:
    """Style Gram targets summed over the style image's own bands."""
    b, gh, gw, _ = style_img.shape
    table = layer_table_from_params(params)
    validate_tiling(int(gh), tile_rows, style_layers, table)
    margin, _ = receptive_margin(style_layers, table)
    window_h = tile_rows + 2 * margin
    raw: dict | None = None
    for i, window in enumerate(band_windows(int(gh), tile_rows, margin)):
        grams, _ = _raw_band_partials(
            params, style_img, window, window_h, tile_rows, {}, i,
            style_layers, (), precision,
        )
        raw = _accumulate(raw, grams)
    out = {}
    for idx in style_layers:
        scale = 2 ** pools_before_in(table, idx)
        n_norm = b * (gh // scale) * (gw // scale) * table[idx][2]
        out[idx] = torch.clamp(raw[idx], max=GRAM_MATRIX_CLAMP_MAX) / n_norm
    return out


def _tiled_content_feats(
    params: Params,
    content_img: torch.Tensor,
    content_layers: tuple[int, ...],
    tile_rows: int,
    precision: PrecisionLike,
) -> dict[int, torch.Tensor]:
    """Content targets written band by band into full-size maps.

    The maps are the one full-size feature state a banded run holds:
    targets persist for the whole run.
    """
    b, gh, gw, _ = content_img.shape
    table = layer_table_from_params(params)
    validate_tiling(int(gh), tile_rows, content_layers, table)
    margin, _ = receptive_margin(content_layers, table)
    window_h = tile_rows + 2 * margin
    # Every row is written by exactly one band.
    feats = {
        idx: torch.empty(
            (
                b, gh // 2 ** pools_before_in(table, idx),
                gw // 2 ** pools_before_in(table, idx), table[idx][2],
            ),
            dtype=content_img.dtype, device=content_img.device,
        )
        for idx in content_layers
    }
    for i, (start, offset) in enumerate(
        band_windows(int(gh), tile_rows, margin),
    ):
        acts = extract_features(
            params, content_img[:, start:start + window_h],
            content_layers, precision,
        )
        for idx in content_layers:
            scale = 2 ** pools_before_in(table, idx)
            rows = tile_rows // scale
            lo = offset // scale
            feats[idx][:, i * rows:(i + 1) * rows] = acts[idx][:, lo:lo + rows]
    return feats


@torch.no_grad()
def compute_tiled_targets(
    params: Params,
    style_img: torch.Tensor,
    content_img: torch.Tensor,
    style_layers: tuple[int, ...],
    content_layers: tuple[int, ...],
    tile_rows_style: int | None = None,
    tile_rows_content: int | None = None,
    precision: PrecisionLike = MIXED,
) -> Targets:
    """Targets via band tiling; either image may also run whole.

    Style Gram targets accumulate across the style image's bands;
    content activation targets are written band by band into full-size
    maps. With neither band height set it is ``compute_targets``.
    """
    style_layers = tuple(style_layers)
    content_layers = tuple(content_layers)
    if tile_rows_style is None and tile_rows_content is None:
        return compute_targets(
            params, style_img, content_img, style_layers, content_layers,
            precision,
        )
    if tile_rows_style is None:
        style_grams = compute_targets(
            params, style_img, content_img, style_layers, (), precision,
        ).style_grams
    else:
        style_grams = _tiled_style_grams(
            params, style_img, style_layers, tile_rows_style, precision,
        )
    if not content_layers:
        content_feats: dict[int, torch.Tensor] = {}
    elif tile_rows_content is None:
        content_feats = compute_targets(
            params, style_img, content_img, (), content_layers, precision,
        ).content_feats
    else:
        content_feats = _tiled_content_feats(
            params, content_img, content_layers, tile_rows_content,
            precision,
        )
    return Targets(style_grams=style_grams, content_feats=content_feats)
