"""Coarse-to-fine warm start: seed the full-size run from a pyramid.

The port of the JAX package's ``engine/coarse.py``. ``coarse_init``
optimizes downsampled copies of the problem for ``coarse_steps`` steps
in all, coarsest level first, each level warm-starting the next, and
resizes the last level's image to full size as the starting image. The
coarsest level starts from ``init_method``. With ``coarse_steps=-1``
(the default) the warm start turns itself on for content of at least
1 MP, with a budget of ``steps // 5`` (:func:`resolve_coarse_steps`).

Every level runs the same kernels as the full-size run, at its own
shape. The JAX package's banded and rematerialized levels (above 4.2
MP, so for content of about 17 MP and up) are not ported: such a level
raises. :func:`multi_coarse_init` is the same schedule for the
multi-style batch: every level optimizes all S styles in one stacked
step, each against its own style resized to the level.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch.constants import (
    AUTO_REMAT_PIXEL_THRESHOLD,
    AUTO_TILE_PIXEL_THRESHOLD,
)
from style_transfer_visualizer_tpu_torch.engine.runner import DEFAULT_CHUNK
from style_transfer_visualizer_tpu_torch.engine.step import (
    build_update_step,
    drive_chunked,
)
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
    initialize_input,
    targets_maybe_blended,
)
from style_transfer_visualizer_tpu_torch.ops.lap import lap_response
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    build_multi_style_update,
    initialize_multi_inputs,
    multi_style_targets,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

# Four 2x2 pools sit above the deepest default tap; multiples of 16
# stay even through every one of them.
_POOL_ALIGN = 16
# Below this the coarse problem carries too little structure to help.
_MIN_COARSE_DIM = 32
# The pooled Laplacian stencil needs a 3x3 response.
_MIN_LAP_POOLED = 3

#: Auto mode turns the warm start on for content of this many pixels.
AUTO_COARSE_MIN_PIXELS = 1_000_000
#: Auto budget: ``coarse_steps = steps // 5``.
AUTO_COARSE_STEPS_DIVISOR = 5


def resolve_coarse_steps(
    requested: int,
    height: int,
    width: int,
    steps: int,
) -> int:
    """Resolve ``coarse_steps=-1`` (auto) against the content size.

    Explicit values (>= 0) pass through; auto is ``steps // 5`` (at
    least 1) for content of at least ``AUTO_COARSE_MIN_PIXELS``, else 0.
    """
    if requested >= 0:
        return requested
    if height * width < AUTO_COARSE_MIN_PIXELS:
        return 0
    resolved = max(1, steps // AUTO_COARSE_STEPS_DIVISOR)
    logger.info(
        "Coarse warm start auto-enabled for %dx%d content: %d "
        "half-resolution steps (disable with --coarse-steps 0).",
        width, height, resolved,
    )
    return resolved


def coarse_dims(height: int, width: int) -> tuple[int, int] | None:
    """Half resolution rounded down to pool alignment; None if too small."""
    ch = height // 2 // _POOL_ALIGN * _POOL_ALIGN
    cw = width // 2 // _POOL_ALIGN * _POOL_ALIGN
    if ch < _MIN_COARSE_DIM or cw < _MIN_COARSE_DIM:
        return None
    return ch, cw


def pyramid_dims(
    height: int,
    width: int,
    levels: int,
) -> list[tuple[int, int]]:
    """Coarse-level shapes, coarsest first: 1/2^k for k = levels-1 .. 1.

    Each level rounds down to pool alignment; levels below
    ``_MIN_COARSE_DIM`` are dropped. The full-size level is the
    caller's main run and is never included.
    """
    dims: list[tuple[int, int]] = []
    for k in range(levels - 1, 0, -1):
        factor = 2 ** k
        ch = height // factor // _POOL_ALIGN * _POOL_ALIGN
        cw = width // factor // _POOL_ALIGN * _POOL_ALIGN
        if ch < _MIN_COARSE_DIM or cw < _MIN_COARSE_DIM:
            continue
        dims.append((ch, cw))
    return dims


def plan_pyramid(
    height: int,
    width: int,
    coarse_steps: int,
    levels: int = 2,
) -> list[tuple[int, int, int]]:
    """Warm-start schedule ``[(ch, cw, steps), ...]``, coarsest first.

    Empty when ``coarse_steps`` is 0 or the input is too small to
    halve. The budget splits evenly across the levels, the remainder
    on the coarsest; a level whose share is 0 is dropped.
    """
    if coarse_steps <= 0:
        return []
    dims = pyramid_dims(height, width, levels)
    if not dims:
        logger.info(
            "Coarse warm start skipped: %dx%d is too small to halve.",
            width, height,
        )
        return []
    base, rem = divmod(coarse_steps, len(dims))
    schedule = []
    for i, (ch, cw) in enumerate(dims):
        steps = base + (rem if i == 0 else 0)
        if steps > 0:
            schedule.append((ch, cw, steps))
    return schedule


def _interpolate(
    img: torch.Tensor, height: int, width: int, *, antialias: bool,
) -> torch.Tensor:
    x = F.interpolate(
        img.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
        align_corners=False, antialias=antialias,
    )
    return x.permute(0, 2, 3, 1).contiguous()


def resize_image(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of an (N, H, W, C) batch, as ``jax.image.resize``.

    ``jax.image.resize(method="linear")`` widens its triangle filter
    when it shrinks (antialiasing) and not when it enlarges.
    ``F.interpolate`` matches it only with ``antialias`` on to shrink
    and off to enlarge, so the choice is made per call, and per axis
    when one axis shrinks and the other grows. On standard-normal
    pixels: within 5e-7 at 2:1 and at 1080x1920 <-> 528x960, up to
    1e-5 at ratios such as 999 -> 496 (the two weigh the taps with
    float32 sample positions rounded differently).
    """
    _, h, w, _ = img.shape
    if height <= h and width <= w:
        return _interpolate(img, height, width, antialias=True)
    if height >= h and width >= w:
        return _interpolate(img, height, width, antialias=False)
    img = _interpolate(img, height, w, antialias=height < h)
    return _interpolate(img, height, width, antialias=width < w)


def _check_level_size(ch: int, cw: int) -> None:
    """Raise for a level that needs the banded or remat evaluation."""
    if ch * cw >= min(AUTO_TILE_PIXEL_THRESHOLD, AUTO_REMAT_PIXEL_THRESHOLD):
        msg = (
            f"coarse level {cw}x{ch} needs banded evaluation or "
            "feature rematerialization, which the port does not have "
            "yet (ROADMAP.md queue 6); pass --coarse-steps 0"
        )
        raise NotImplementedError(msg)


def _level_lap(
    opt_cfg, coarse_content: torch.Tensor, ch: int, cw: int,
) -> tuple[float, torch.Tensor | None]:
    """The level's ``(lap_w, lap_target)``.

    The term is skipped at a level whose pooled image is under 3x3;
    otherwise each level matches the Laplacian of its own resized
    content.
    """
    lap_w = opt_cfg.lap_w
    if lap_w and min(ch, cw) // opt_cfg.lap_pool < _MIN_LAP_POOLED:
        logger.info(
            "Coarse level %dx%d is too small for lap_pool=%d; the "
            "Laplacian term starts at the next level.",
            cw, ch, opt_cfg.lap_pool,
        )
        lap_w = 0.0
    lap_target = (
        lap_response(coarse_content, opt_cfg.lap_pool) if lap_w else None
    )
    return lap_w, lap_target


def coarse_init(
    params,
    content_img: torch.Tensor,
    style_img: torch.Tensor,
    config,
    generator: torch.Generator | None,
    *,
    blend_imgs: list[tuple[torch.Tensor, float]] | None = None,
) -> torch.Tensor | None:
    """Warm-started full-size starting image, or None when coarse is off.

    Runs ``optimization.coarse_steps`` steps of the configured
    optimizer across the ``optimization.pyramid_levels`` coarse levels
    and resizes the last level's image to full size. None when
    ``coarse_steps`` is 0 or the image is too small to halve. A blended
    run (``blend_imgs``) blends the same styles at every level.
    """
    opt_cfg = config.optimization
    _, height, width, _ = content_img.shape
    schedule = plan_pyramid(
        int(height), int(width), opt_cfg.coarse_steps,
        opt_cfg.pyramid_levels,
    )
    if not schedule:
        return None
    x: torch.Tensor | None = None
    for ch, cw, steps in schedule:
        start = resize_image(x, ch, cw) if x is not None else None
        logger.info(
            "Coarse warm start: %d steps at %dx%d before %dx%d.",
            steps, cw, ch, width, height,
        )
        x = _optimize_level(
            params, content_img, style_img, config, generator, ch, cw,
            steps, blend_imgs=blend_imgs, start=start,
        )
    return resize_image(x, int(height), int(width))


def _optimize_level(
    params,
    content_img: torch.Tensor,
    style_img: torch.Tensor,
    config,
    generator: torch.Generator | None,
    ch: int,
    cw: int,
    steps: int,
    *,
    blend_imgs: list[tuple[torch.Tensor, float]] | None,
    start: torch.Tensor | None,
) -> torch.Tensor:
    """Optimize one coarse level at (ch, cw); return the level's image.

    ``start`` is the coarser level's image already resized to this
    level; None starts the coarsest level from ``init_method``.
    """
    _check_level_size(ch, cw)
    opt_cfg = config.optimization
    coarse_content = resize_image(content_img, ch, cw)
    coarse_style = resize_image(style_img, ch, cw)
    style_layers = tuple(opt_cfg.style_layers)
    content_layers = tuple(opt_cfg.content_layers)

    def one_targets(s_img, content_layers_):
        return compute_targets(
            params, s_img, coarse_content, style_layers, content_layers_,
        )

    coarse_blend = None
    if blend_imgs is not None:
        coarse_blend = [
            (resize_image(img, ch, cw), weight) for img, weight in blend_imgs
        ]
    targets = targets_maybe_blended(
        one_targets, coarse_style, content_layers, coarse_blend,
    )
    lap_w, lap_target = _level_lap(opt_cfg, coarse_content, ch, cw)
    bundle = build_update_step(
        params, targets, tuple(coarse_content.shape),
        optimizer=opt_cfg.optimizer,
        lr=opt_cfg.lr,
        style_w=opt_cfg.style_w,
        content_w=opt_cfg.content_w,
        tv_w=opt_cfg.tv_w,
        lap_w=lap_w,
        lap_pool=opt_cfg.lap_pool,
        lap_target=lap_target,
        style_layers=style_layers,
        content_layers=content_layers,
        style_weights=opt_cfg.style_weights_tuple(),
        lbfgs_max_iter=opt_cfg.lbfgs_max_iter,
        lbfgs_max_eval=opt_cfg.lbfgs_max_eval,
        lbfgs_history_size=opt_cfg.lbfgs_history_size,
        lbfgs_history_dtype=opt_cfg.lbfgs_history_dtype,
        lbfgs_direction=opt_cfg.lbfgs_direction,
    )
    x = (
        initialize_input(coarse_content, opt_cfg.init_method, generator)
        if start is None
        else start
    )
    x, _, aux = drive_chunked(
        bundle.chunked_update_fn, x, bundle.opt_state, steps, DEFAULT_CHUNK,
    )
    # The level's one host read.
    logger.info(
        "Coarse level %dx%d done (final loss %.4g).",
        cw, ch, float(aux.loss[-1]),
    )
    return x


def multi_coarse_init(
    params,
    content_img: torch.Tensor,
    style_imgs: list[torch.Tensor],
    config,
    generator: torch.Generator | None,
) -> torch.Tensor | None:
    """Warm-started ``(S, 1, H, W, 3)`` starting images, or None.

    The batch's :func:`coarse_init` (the JAX package's
    ``main._multi_initial_images``): the same schedule, each level one
    stacked problem of all S styles against its own per-style targets
    at that level, the Laplacian skipped below ``3 * lap_pool``. The
    stacked images are resized between levels and to full size with
    :func:`resize_image`. None when ``coarse_steps`` is 0 or the image
    is too small to halve.
    """
    opt_cfg = config.optimization
    _, height, width, _ = content_img.shape
    schedule = plan_pyramid(
        int(height), int(width), opt_cfg.coarse_steps,
        opt_cfg.pyramid_levels,
    )
    if not schedule:
        return None
    n_styles = len(style_imgs)
    x: torch.Tensor | None = None
    for ch, cw, steps in schedule:
        _check_level_size(ch, cw)
        coarse_content = resize_image(content_img, ch, cw)
        targets = multi_style_targets(
            params, coarse_content,
            [resize_image(s, ch, cw) for s in style_imgs],
            tuple(opt_cfg.style_layers), tuple(opt_cfg.content_layers),
        )
        lap_w, lap_target = _level_lap(opt_cfg, coarse_content, ch, cw)
        bundle = build_multi_style_update(
            params, targets, tuple(coarse_content.shape), n_styles,
            optimizer=opt_cfg.optimizer,
            lr=opt_cfg.lr,
            style_w=opt_cfg.style_w,
            content_w=opt_cfg.content_w,
            tv_w=opt_cfg.tv_w,
            lap_w=lap_w,
            lap_pool=opt_cfg.lap_pool,
            lap_target=lap_target,
            style_layers=tuple(opt_cfg.style_layers),
            style_weights=opt_cfg.style_weights_tuple(),
            content_layers=tuple(opt_cfg.content_layers),
            lbfgs_max_iter=opt_cfg.lbfgs_max_iter,
            lbfgs_max_eval=opt_cfg.lbfgs_max_eval,
            lbfgs_history_size=opt_cfg.lbfgs_history_size,
            lbfgs_history_dtype=opt_cfg.lbfgs_history_dtype,
            lbfgs_direction=opt_cfg.lbfgs_direction,
        )
        if x is None:
            x = initialize_multi_inputs(
                coarse_content, opt_cfg.init_method, generator, n_styles,
            )
        else:
            x = resize_image(x[:, 0], ch, cw)[:, None]
        logger.info(
            "Coarse warm start: %d stacked steps at %dx%d for %d styles.",
            steps, cw, ch, n_styles,
        )
        x, _, aux = drive_chunked(
            bundle.chunked_update_fn, x, bundle.opt_state, steps,
            DEFAULT_CHUNK,
        )
        # The level's one host read.
        logger.info(
            "Coarse level %dx%d done (final losses %s).",
            cw, ch, ", ".join(f"{v:.4g}" for v in aux.loss[-1].tolist()),
        )
    return resize_image(x[:, 0], int(height), int(width))[:, None]
