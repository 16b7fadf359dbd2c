"""Regional (masked) style transfer: a different style per image region.

The port of the JAX package's ``regional.py``: spatial style control
after Gatys et al. 2017 ("Controlling Perceptual Factors in Neural
Style Transfer", arXiv:1611.07865 §4). Each style s carries a guidance
mask m_s over the content image; at every style layer the stylized
features are weighted by the mask (resized to the layer's resolution)
before the Gram, so style s's loss only sees, and only paints, its own
region.

The masked Gram reuses the Gram kernel: weighting the features by
``sqrt(m * P / mass)`` and calling ``ops.gram.gram_matrix`` (the
hand-written kernel on the card) gives ``sum_p m[p] F[p,c1] F[p,c2] /
(mass * C)``, the average correlation over the masked region, on the
same scale as the style's full-image Gram; an all-ones mask gives a
scale of exactly 1 and so the stock Gram. The kernel's backward (the
clamp-aware ``dF = F S``) carries over unchanged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.engine.coarse import resize_image
from style_transfer_visualizer_tpu_torch.main import run_with_artifacts
from style_transfer_visualizer_tpu_torch.media.modes import select_video_mode
from style_transfer_visualizer_tpu_torch.models.arch import get_architecture
from style_transfer_visualizer_tpu_torch.models.features import (
    _resolve_style_weights,
    _weighted,
    compute_targets,
    extract_features,
    initialize_input,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    load_pretrained_params,
)
from style_transfer_visualizer_tpu_torch.ops.gram import gram_matrix
from style_transfer_visualizer_tpu_torch.ops.precision import (
    HIGH,
    PrecisionLike,
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.ops.lap import lap_loss, lap_response
from style_transfer_visualizer_tpu_torch.ops.tv import tv_loss
from style_transfer_visualizer_tpu_torch.runtime.device import (
    setup_device,
    setup_random_seed,
)
from style_transfer_visualizer_tpu_torch.runtime.validation import (
    validate_input_paths,
    validate_parameters,
)
from style_transfer_visualizer_tpu_torch.sequence import build_targets_update
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import StyleTransferConfig
    from style_transfer_visualizer_tpu_torch.models.vgg19 import Params

_MASK_EPS = 1e-6
_MIN_STYLES = 2


@dataclass(frozen=True)
class RegionalTargets:
    """Targets of a masked multi-region run.

    ``style_grams[s]`` maps layer index -> the (C, C) full-image Gram
    of style s; ``masks`` is (S, H, W), a pixelwise partition of the
    content canvas (the S masks sum to 1 everywhere); ``content_feats``
    is the usual content-layer activation dict.
    """

    style_grams: list[dict[int, torch.Tensor]]
    content_feats: dict[int, torch.Tensor]
    masks: torch.Tensor


@dataclass(frozen=True)
class RegionalResult:
    """Outcome of a regional run."""

    output_path: Path
    final_loss: float
    elapsed_seconds: float
    total_steps: int


def load_region_masks(
    mask_paths: list[str | Path],
    height: int,
    width: int,
) -> np.ndarray:
    """Load, resize and partition-normalize the per-style masks.

    Masks decode as grayscale in [0, 1], resized bilinearly (Pillow) to
    the content's (H, W). Pixels are normalized so the S masks sum to 1
    everywhere (overlapping or feathered regions weigh in proportion);
    where every mask is about 0 the styles share the pixel equally. A
    mask with no support at all is refused: its style could never
    appear. Returns the (S, H, W) float32 host array.
    """
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    rows = []
    for p in mask_paths:
        with Image.open(p) as img:
            resized = img.convert("L").resize(
                (width, height), Image.Resampling.BILINEAR,
            )
        rows.append(np.asarray(resized, dtype=np.float32)[None] / 255.0)
    stacked = np.concatenate(rows, axis=0)
    for i, mask_path in enumerate(mask_paths):
        if stacked[i].sum() <= _MASK_EPS:
            msg = (
                f"Region mask {mask_path} is empty (all black) — its "
                "style would never appear"
            )
            raise ValueError(msg)
    total = stacked.sum(axis=0, keepdims=True)
    uniform = np.full_like(stacked, 1.0 / len(rows))
    return np.where(
        total > _MASK_EPS, stacked / np.maximum(total, _MASK_EPS), uniform,
    ).astype(np.float32)


def masked_gram(
    features: torch.Tensor,
    mask: torch.Tensor,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """Region-average Gram ``sum_p m F F / (mass * C)`` of (B, H, W, C).

    ``mask`` is (H', W') at any resolution; it is resized to the
    feature map's (H, W) by ``engine.coarse.resize_image`` (bilinear,
    antialiased when it shrinks, as ``jax.image.resize``) and applied
    as the feature weight ``sqrt(m * P / mass)``, so the Gram's ``/ (P
    * C)`` lands on ``/ (mass * C)``. The Gram's clamp (5e5, before the
    divide) applies to the scaled raw sum, as in the JAX package. The
    Gram runs at ``precision`` as ``ops.gram.gram_matrix`` does.
    """
    b, h, w, _ = features.shape
    mask_l = resize_image(mask[None, :, :, None], h, w)[0, :, :, 0]
    mask_l = torch.clamp(mask_l, min=0.0)
    mass = torch.clamp(torch.sum(mask_l), min=_MASK_EPS)
    scale = torch.sqrt(mask_l * (b * h * w / mass))
    return gram_matrix(features * scale[None, :, :, None], precision=precision)


def regional_style_loss(
    acts: dict[int, torch.Tensor],
    rt: RegionalTargets,
    style_layers: tuple[int, ...],
    *,
    style_weights: tuple[float, ...] | None = None,
    precision: PrecisionLike = HIGH,
) -> torch.Tensor:
    """Sum over styles and layers of the masked-Gram MSE to each target.

    ``style_weights`` weighs each layer as in the unmasked loss
    (``models/features.py``), the same for every region; the Grams run
    at ``precision``.
    """
    weights = _resolve_style_weights(style_weights, style_layers)
    total = torch.zeros((), dtype=rt.masks.dtype, device=rt.masks.device)
    for s in range(rt.masks.shape[0]):
        for idx, w in zip(style_layers, weights, strict=True):
            g = masked_gram(acts[idx], rt.masks[s], precision)
            total = total + _weighted(
                w, torch.mean(torch.square(g - rt.style_grams[s][idx])),
            )
    return total


def make_regional_loss(cfg: StyleTransferConfig):
    """``loss_fn(params, image, targets) -> (total, (style, content))``.

    ``targets`` is a :class:`RegionalTargets`; with ``lap_w`` set, the
    pair ``(RegionalTargets, lap_target)``: the Laplacian holds the
    whole content photo's edges, like the content term, whatever the
    regions. The convs and Grams run at ``cfg.hardware.precision``.
    """
    opt = cfg.optimization
    precision = resolve_precision(cfg.hardware.precision)
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)
    taps = tuple(sorted(set(style_layers) | set(content_layers)))
    style_weights = opt.style_weights_tuple()

    def loss_fn(params: Params, img: torch.Tensor, rt):
        lap_target = None
        if opt.lap_w:
            rt, lap_target = rt
        acts = extract_features(params, img, taps, precision)
        style_score = regional_style_loss(
            acts, rt, style_layers, style_weights=style_weights,
            precision=precision,
        )
        content_losses = [
            torch.mean(torch.square(acts[idx] - rt.content_feats[idx]))
            for idx in content_layers
        ]
        content_score = (
            torch.stack(content_losses).sum()
            if content_losses
            else torch.zeros((), dtype=img.dtype, device=img.device)
        )
        total = opt.style_w * style_score + opt.content_w * content_score
        if opt.tv_w:
            total = total + opt.tv_w * tv_loss(img)
        if opt.lap_w:
            total = total + opt.lap_w * lap_loss(img, lap_target, opt.lap_pool)
        return total, (style_score, content_score)

    return loss_fn


def stylize_regional(
    content_path: str | Path,
    style_paths: list[str | Path],
    mask_paths: list[str | Path],
    config: StyleTransferConfig,
) -> RegionalResult:
    """One stylization painting each masked region with its own style.

    Each style's full-image Gram targets are computed once; the
    optimized image's features are weighted by each region's mask
    before their Grams, so each style's loss acts on its own territory.
    The output is ``regional_{content}_x_{s0+s1+...}.png``;
    ``preserve_color`` composes (``match`` remaps every style onto the
    content's palette, ``luminance`` recolors the result).

    The run has the single run's artifact contract through
    ``main.run_with_artifacts``: timelapse MP4/GIF (the intro and outro
    panels show the first style), loss CSV or history and plot,
    checkpoints and resume. Runs on ``config.hardware.device``.
    """
    if config.hardware.spatial_shards > 1:
        # The mask-weighted Grams have no sharded evaluation; running
        # whole would not be the memory layout asked for.
        msg = (
            "--spatial-shards is not supported in regional (masked) "
            "mode: the mask-weighted region Grams are evaluated "
            "whole-image. Run without --spatial-shards (banded "
            "evaluation auto-enables for 4K-class inputs)."
        )
        raise ValueError(msg)
    if len(style_paths) < _MIN_STYLES:
        msg = (
            "Regional transfer needs at least 2 --styles entries, got "
            f"{len(style_paths)}"
        )
        raise ValueError(msg)
    if len(mask_paths) != len(style_paths):
        msg = (
            f"Got {len(mask_paths)} --style-masks for "
            f"{len(style_paths)} --styles (need one mask per style)"
        )
        raise ValueError(msg)
    for style_path in style_paths:
        validate_input_paths(str(content_path), str(style_path))
    for mask_path in mask_paths:
        if not Path(mask_path).exists():
            msg = f"Region mask not found: {mask_path}"
            raise FileNotFoundError(msg)
    validate_parameters(config.video.quality)
    config.validate()
    # The single run's final-only cascade.
    if config.video.final_only:
        config.video.create_video = False
        config.video.create_gif = False
        config.video.save_every = config.optimization.steps + 1
    device = setup_device(config.hardware.device)
    generator = setup_random_seed(config.optimization.seed, device)
    return _regional_on_device(
        Path(content_path), [Path(p) for p in style_paths],
        [Path(p) for p in mask_paths], config, device, generator,
    )


def _regional_on_device(
    content_path: Path,
    style_paths: list[Path],
    mask_paths: list[Path],
    config: StyleTransferConfig,
    device: torch.device,
    generator: torch.Generator,
) -> RegionalResult:
    start = time.perf_counter()
    opt = config.optimization
    content_host = image_io.load_image_to_host_array(content_path)
    content_img = image_io.host_array_to_device(
        content_host, device, normalize=opt.normalize,
    )
    match_to = content_host if opt.preserve_color == "match" else None
    chroma_source = (
        image_io.host_array_to_device(content_host, device)
        if opt.preserve_color == "luminance"
        else None
    )
    style_imgs = [
        image_io.load_style_image_to_array(
            p, device, normalize=opt.normalize, match_to=match_to,
        )
        for p in style_paths
    ]
    _, height, width, _ = content_img.shape
    masks = torch.as_tensor(
        load_region_masks(list(mask_paths), int(height), int(width)),
        device=device,
    )
    params = load_pretrained_params(
        device, arch=get_architecture(opt.model),
        allow_random=opt.allow_random_weights, seed=opt.seed,
    )
    style_layers = tuple(opt.style_layers)
    content_layers = tuple(opt.content_layers)
    precision = resolve_precision(config.hardware.precision)
    per_style = [
        compute_targets(
            params, s_img, content_img, style_layers,
            content_layers if i == 0 else (), precision,
        )
        for i, s_img in enumerate(style_imgs)
    ]
    rtargets = RegionalTargets(
        style_grams=[t.style_grams for t in per_style],
        content_feats=per_style[0].content_feats,
        masks=masks,
    )
    if opt.lap_w:
        rtargets = (rtargets, lap_response(content_img, opt.lap_pool))
    update, update_many, init_state, run_params = build_targets_update(
        params, tuple(content_img.shape), config,
        loss_fn=make_regional_loss(config),
    )
    # The single run's auto video mode: long or large timelapses
    # promote realtime to postprocess.
    if config.video.create_video:
        effective_mode, reason, frame_estimate = select_video_mode(
            config.video,
            frame_size=(int(width), int(height)),
            total_steps=opt.steps,
        )
        config.video.mode = effective_mode
        if reason is not None:
            logger.info(
                "Auto-selected postprocess video mode (%s). "
                "Estimated frames: %d.",
                reason, frame_estimate,
            )
    x = initialize_input(content_img, opt.init_method, generator)
    joined = "+".join(p.stem.replace(" ", "_") for p in style_paths)
    content_name = content_path.stem.replace(" ", "_")
    result = run_with_artifacts(
        lambda img, st: update(img, st, run_params, rtargets),
        lambda img, st, k: update_many(img, st, run_params, rtargets, k),
        init_state(),
        x,
        config,
        content_path=content_path,
        style_path=style_paths[0],
        style_name=joined,
        chroma_source=chroma_source,
        final_name=f"regional_{content_name}_x_{joined}.png",
    )
    elapsed = time.perf_counter() - start
    logger.info(
        "Regional stylization (%d styles, loss %.4g, %.2fs): %s",
        len(style_paths), result.final_total_loss, elapsed,
        result.final_path,
    )
    return RegionalResult(
        output_path=result.final_path,
        final_loss=result.final_total_loss,
        elapsed_seconds=elapsed,
        total_steps=opt.steps,
    )
