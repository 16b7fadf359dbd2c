"""Command line of the port: one content image, one style, a blend,
the multi-style batch, a blend sweep or regional masks.

    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --style s.png --steps 300 --device cuda
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png --style-blend 0.7,0.3
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png --blend-sweep 8
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png --style-masks m1.png,m2.png

The flags the port supports carry the JAX package's names and defaults:
the optimization flags of the single run (the optimizer, the TV and
Laplacian terms, per-layer style weights, color preservation, the
model, the coarse warm start), the style blend, and the output and
video flags of the timelapse (``--save-every``, ``--no-video``,
``--gif``, ``--log-loss``, ``--compare-inputs`` and the rest), the
checkpoint flags (``--checkpoint-every``, ``--checkpoint-path``,
``--resume-from``), ``--profile-dir``, ``--precision`` (the four tiers,
``ops/precision.py``), ``--steps-per-dispatch`` (on the
card every step is a CUDA-graph replay; the value sets the chunk
between host reads), ``--tile-rows`` and ``--remat`` (banded
evaluation and rematerialization, automatic past the H100 thresholds
of ``constants.py``), ``--spatial-shards`` (the image's rows over N
processes, one card each, ``parallel/spatial.py``), and ``--config``
(a TOML in the JAX package's layout, under the typed flags) with
``--validate-config-only``. A realtime or postprocess MP4 needs
``ffmpeg`` on PATH; the GIF needs imageio. ``--styles`` without
``--style-blend`` is the JAX package's per-style batch: one
stylization per style, all in one stacked step
(``main.multi_style_transfer``). ``--blend-sweep N`` renders an N-frame
morph across the styles (``blend_sweep.stylize_blend_sweep``) and
``--style-masks`` paints one style per masked region
(``regional.stylize_regional``); the JAX package's checks and dispatch
order apply: masks, then sweep, then blend, then the batch.
"""
from __future__ import annotations

import argparse
import copy
from collections.abc import Sequence
from pathlib import Path

from style_transfer_visualizer_tpu_torch import config_defaults as d
from style_transfer_visualizer_tpu_torch.blend_sweep import stylize_blend_sweep
from style_transfer_visualizer_tpu_torch.config import (
    ConfigLoader,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.constants import (
    AUTO_REMAT_PIXEL_THRESHOLD,
    AUTO_TILE_PIXEL_THRESHOLD,
    BATCH_AUTO_REMAT_PIXEL_THRESHOLD,
    MAX_BAND_PIXELS,
)
from style_transfer_visualizer_tpu_torch.main import (
    multi_style_transfer,
    style_transfer,
)
from style_transfer_visualizer_tpu_torch.ops.precision import PRECISION_NAMES
from style_transfer_visualizer_tpu_torch.regional import stylize_regional
from style_transfer_visualizer_tpu_torch.runtime.comparison import (
    ComparisonRequest,
    render_requested_comparisons,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger


def _int_list(text: str) -> list[int]:
    return [int(part) for part in text.split(",")]


def _float_list(text: str) -> list[float]:
    return [float(part) for part in text.split(",")]


def _add_optimization_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--steps", type=int)
    p.add_argument("--device")
    p.add_argument(
        "--precision", choices=list(PRECISION_NAMES),
        help=(
            "Matmul precision tier of the conv and Gram kernels on the "
            "card: 'highest' runs IEEE fp32 on the CUDA cores "
            "everywhere; 'mixed' (the default) runs the first two VGG "
            "blocks' forward convs and the Gram products in IEEE fp32 "
            "and the rest in 3xTF32 (the JAX package's curve-parity "
            "policy); 'high' runs 3xTF32 on the tensor cores "
            "everywhere (about 21 mantissa bits); 'default' runs one "
            "TF32 product (about 11 bits an operand) for top speed, "
            "with gradients that deviate. On the CPU every tier is "
            "plain fp32."
        ),
    )
    p.add_argument(
        "--steps-per-dispatch", dest="steps_per_dispatch", type=int,
        help=(
            "Fuse this many optimizer steps into one device "
            "dispatch to amortize host overhead. 0 = auto (gcd "
            "of logging/frame cadences); 1 disables fusion."
        ),
    )
    p.add_argument(
        "--spatial-shards", dest="spatial_shards", type=int,
        help=(
            "Shard image rows across this many processes, one card "
            "each (halo-exchange convolutions, Gram partials summed "
            "over NCCL). Requires that many attached cards; on "
            "--device cpu the ranks run gloo on the host."
        ),
    )
    p.add_argument("--seed", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument(
        "--style-w", type=float,
    )
    p.add_argument(
        "--content-w", type=float,
    )
    p.add_argument(
        "--tv-w", type=float,
        help=(
            "Total-variation weight: adds a smoothness regularizer on "
            "the optimized image to the objective (0, the default, "
            "leaves the style+content loss alone). Computed in the "
            "model's working space; the coarse warm start uses it too."
        ),
    )
    p.add_argument(
        "--lap-w", type=float,
        help=(
            "Laplacian detail-preservation weight (Lapstyle, Li et al. "
            "2017): penalizes edge-structure drift from the content "
            "photo via pooled-Laplacian response matching (0, the "
            "default, leaves the style+content loss alone)."
        ),
    )
    p.add_argument(
        "--lap-pool", type=int,
        help=(
            "Mean-pool size before the Laplacian stencil (default 4): "
            "larger values match coarser edge structure and cost less."
        ),
    )
    p.add_argument(
        "--preserve-color",
        choices=("off", "luminance", "match"),
        help=(
            "Keep the content image's colors (Gatys et al. 2016): "
            "'luminance' recombines the stylized luminance with the "
            "content's chrominance in every output (final PNG, "
            "timelapse frames); 'match' remaps the style image onto "
            "the content's color statistics before style targets are "
            "computed. 'off' (default) inherits the style's palette."
        ),
    )
    p.add_argument(
        "--init-method",
        choices=("content", "random", "white"),
    )
    p.add_argument(
        "--style-layers", type=_int_list,
        help="Comma-separated VGG layer indices for the style loss",
    )
    p.add_argument(
        "--content-layers", type=_int_list,
        help="Comma-separated VGG layer indices for the content loss",
    )
    p.add_argument(
        "--style-layer-weights", type=_float_list,
        help=(
            "Comma-separated per-layer style weights (one per "
            "--style-layers entry, e.g. '1,1,0.5,0.25,0.25'); each "
            "layer's Gram MSE scales by its weight before the style "
            "sum. Omit for equal weighting."
        ),
    )
    p.add_argument(
        "--optimizer",
        choices=("lbfgs", "adam"),
        help="Pixel optimizer (default: lbfgs)",
    )
    p.add_argument(
        "--model", choices=("vgg19", "vgg16"),
        help=(
            "Feature backbone (default: vgg19). With vgg16, layer lists "
            "left at the VGG19 defaults remap to vgg16's own standard "
            "taps (style 0,5,10,17,24; content 19); explicit "
            "--style-layers/--content-layers are used as given."
        ),
    )
    p.add_argument(
        "--coarse-steps", type=int,
        help=(
            "Warm start: optimize N steps at half resolution and "
            "upsample the result as the starting image. -1 = auto "
            "(default): on for >=1MP content with a steps/5 budget. "
            "0 disables."
        ),
    )
    p.add_argument(
        "--pyramid-levels", type=int,
        help=(
            "Resolutions in the coarse-to-fine warm start: 2 (default) "
            "runs one half-res phase; N ladders up from 1/2^(N-1), each "
            "level warm-starting the next. The --coarse-steps budget "
            "splits across the levels. No effect unless --coarse-steps "
            "> 0."
        ),
    )
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument(
        "--lbfgs-history-size", type=int,
    )
    p.add_argument(
        "--lbfgs-history-dtype",
        choices=("float32", "bfloat16"),
    )
    p.add_argument(
        "--lbfgs-direction",
        choices=("two-loop", "compact"),
    )
    p.add_argument(
        "--remat", action="store_true",
        help=(
            "Rematerialize the VGG feature segments in the backward "
            "pass: about one more forward for 8%% less memory. On the "
            "H100 it turns itself on from "
            f"{BATCH_AUTO_REMAT_PIXEL_THRESHOLD:,} pixels x styles in "
            "the batch, and in a single run from "
            f"{AUTO_REMAT_PIXEL_THRESHOLD:,} px only where no exact "
            "band tiling exists."
        ),
    )
    p.add_argument(
        "--tile-rows", dest="tile_rows", type=int,
        help=(
            "Evaluate the loss band by band over rows of this height "
            "(exact; holds one band's activations at a time). 0 forces "
            "whole-image; omitted/-1 = auto: bands from "
            f"{AUTO_TILE_PIXEL_THRESHOLD:,} px on the H100, each window "
            f"at most {MAX_BAND_PIXELS:,} px."
        ),
    )
    p.add_argument(
        "--allow-random-weights", action="store_true",
        help="use seeded random VGG weights when none are found",
    )


def _add_output_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--output")
    p.add_argument(
        "--log-every", type=int,
        help="loss sync cadence, and CSV row cadence with --log-loss",
    )
    p.add_argument(
        "--no-plot", action="store_true", help="Disable loss plotting",
    )
    p.add_argument(
        "--log-loss",
        help=(
            "Path to a CSV file for the loss metrics. The series then "
            "goes to disk instead of memory, and the loss plot is off."
        ),
    )
    p.add_argument(
        "--checkpoint-every", type=int,
        help=(
            "Save a resumable checkpoint (image + optimizer state) every "
            "N steps (0 disables; default 0)."
        ),
    )
    p.add_argument(
        "--checkpoint-path",
        help="Checkpoint file path (default: <output>/checkpoint.npz).",
    )
    p.add_argument(
        "--resume-from",
        help="Resume optimization from a saved checkpoint file.",
    )
    p.add_argument(
        "--profile-dir",
        help=(
            "Write a torch.profiler trace of the optimization loop to "
            "this directory (view with TensorBoard or Perfetto)."
        ),
    )
    p.add_argument(
        "--compare-inputs", action="store_true", default=False,
        help="Save a labeled comparison image of content and style.",
    )
    p.add_argument(
        "--compare-result", action="store_true", default=False,
        help=(
            "Save a labeled comparison image of content, style and "
            "the stylized result."
        ),
    )


def _add_video_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--save-every", type=int,
        help="Save a timelapse frame every N steps",
    )
    p.add_argument(
        "--fps", type=int,
        help="Frames per second for video",
    )
    p.add_argument(
        "--quality", type=int,
        help="Video quality, 1-10 (10 is best)",
    )
    p.add_argument(
        "--no-video", action="store_true", help="Disable video creation",
    )
    p.add_argument(
        "--final-only", action="store_true", help="Only save final image",
    )
    p.add_argument(
        "--no-intro", action="store_true",
        help="Disable the intro comparison segment in the video",
    )
    p.add_argument(
        "--intro-duration", type=float,
        help="Seconds to hold the intro comparison frame",
    )
    p.add_argument(
        "--no-final-frame-compare", dest="final_frame_compare",
        action="store_false",
        help="End the timelapse on the last stylization step",
    )
    p.add_argument(
        "--outro-duration", type=float,
        help="Seconds to hold the final comparison frame",
    )
    p.add_argument("--metadata-title")
    p.add_argument("--metadata-artist")
    p.add_argument(
        "--gif", dest="create_gif", action="store_true",
        help=(
            "Also export a GIF timelapse (intro/outro segments are "
            "skipped unless explicitly included)."
        ),
    )
    p.add_argument(
        "--no-gif", dest="create_gif", action="store_false",
        help="Disable GIF export.",
    )
    p.add_argument(
        "--gif-include-intro", action="store_true",
        help="Include the intro comparison segment in GIF output.",
    )
    p.add_argument(
        "--gif-include-outro", action="store_true",
        help="Include the outro comparison segment in GIF output.",
    )
    p.add_argument(
        "--video-mode", choices=("realtime", "postprocess"),
        help=(
            "realtime streams frames into ffmpeg, postprocess encodes "
            "after the optimization. When omitted, long runs may switch "
            "to postprocess."
        ),
    )


def build_parser() -> argparse.ArgumentParser:
    """The argument parser of the port's CLI.

    A flag the user did not type is absent from the parsed namespace
    (``argparse.SUPPRESS``), so only typed flags override the TOML of
    ``--config`` or the defaults (:func:`config_from_args`).
    """
    p = argparse.ArgumentParser(
        prog="style_transfer_visualizer_tpu_torch.cli",
        description="Neural style transfer on PyTorch/CUDA.",
        argument_default=argparse.SUPPRESS,
    )
    p.add_argument("--content", default=None, help="content image file")
    p.add_argument("--style", default=None, help="style image file")
    p.add_argument(
        "--styles", default=None,
        help=(
            "Comma-separated style image paths. Alone: the multi-style "
            "batch, one stylization per style, all styles in one "
            "stacked step (stylized_{c}_x_{s}.png per style, and one "
            "timelapse GIF and/or postprocess MP4 per style). With "
            "--style-blend: one stylization from their blended Gram "
            "targets."
        ),
    )
    p.add_argument(
        "--style-blend", default=None,
        help=(
            "Comma-separated weights, one per --styles entry: blends "
            "the styles' Gram targets into ONE interpolated "
            "stylization. Weights normalize to sum 1; outputs are "
            "named with the joined style stems "
            "(stylized_{c}_x_{s1+s2}.png) and gallery intro/outro "
            "panels show the highest-weight style."
        ),
    )
    p.add_argument(
        "--style-masks", default=None,
        help=(
            "Comma-separated grayscale mask paths, one per --styles "
            "entry: regional style transfer (Gatys et al. 2017 spatial "
            "control) — each style's Gram loss is restricted to its "
            "masked region, so one stylization paints different "
            "regions with different styles. Masks resize to the "
            "content's dims and normalize to a pixelwise partition; "
            "output is regional_{c}_x_{s1+s2}.png."
        ),
    )
    p.add_argument(
        "--blend-sweep", type=int, default=None,
        help=(
            "Render an N-frame morph animation across the --styles "
            "list (piecewise-linear blend-weight traversal, each frame "
            "a converged stylization warm-started from the previous "
            "one). Frames save as sweep_NNNN.png plus a "
            "blend_sweep_{c}_x_{s1+s2}.gif at the --fps rate. "
            "Incompatible with --style-blend (the sweep generates its "
            "own weights)."
        ),
    )
    p.add_argument(
        "--sweep-steps", type=int, default=None,
        help=(
            "Per-frame step budget for blend-sweep frames after the "
            "first (default: --steps). Warm starts converge well below "
            "the cold budget, so a smaller value is the sweep's main "
            "throughput lever."
        ),
    )
    _add_optimization_flags(p)
    _add_output_flags(p)
    _add_video_flags(p)
    p.add_argument(
        "--config", default=None, help="Path to a config.toml file",
    )
    p.add_argument(
        "--validate-config-only", action="store_true", default=False,
        help="Validate the config file and exit without running",
    )
    return p


# Flags copied as they are onto a config section's field of the same
# name (the JAX package's build_config_from_cli merges the same keys).
_COPIED = {
    "output": (
        "output", "log_every", "log_loss", "checkpoint_every",
        "checkpoint_path", "resume_from", "profile_dir",
    ),
    "optimization": (
        "steps", "style_w", "content_w", "tv_w", "lap_w", "lap_pool", "lr",
        "init_method", "seed", "optimizer", "model",
        "lbfgs_history_size", "lbfgs_history_dtype", "lbfgs_direction",
        "coarse_steps", "pyramid_levels", "preserve_color",
        "style_layers", "content_layers", "style_layer_weights",
        "tile_rows",
    ),
    "video": (
        "save_every", "fps", "quality", "metadata_title",
        "metadata_artist", "create_gif", "gif_include_intro",
        "gif_include_outro", "final_frame_compare",
    ),
    "hardware": (
        "device", "precision", "steps_per_dispatch", "spatial_shards",
    ),
}


def config_from_args(
    args: argparse.Namespace,
    base: StyleTransferConfig | None = None,
) -> StyleTransferConfig:
    """Merge the typed flags of ``args`` over ``base``; validate.

    ``base`` is the TOML of ``--config`` or, by default, the defaults.
    Precedence is the JAX package's: flag, then TOML, then default.
    Raises ``ValueError`` for a value out of its bounds.
    """
    config = copy.deepcopy(base) if base is not None else StyleTransferConfig()
    typed = vars(args)
    for section, keys in _COPIED.items():
        for key in keys:
            if key in typed:
                setattr(getattr(config, section), key, typed[key])
    if typed.get("no_plot"):
        config.output.plot_losses = False
    if typed.get("allow_random_weights"):
        config.optimization.allow_random_weights = True
    if typed.get("remat"):
        config.optimization.remat = True
    if typed.get("no_normalize"):
        config.optimization.normalize = False
    video = config.video
    if typed.get("no_video"):
        video.create_video = False
    if typed.get("no_intro"):
        video.intro_enabled = False
    if typed.get("final_only"):
        video.final_only = True
    if "intro_duration" in typed:
        video.intro_duration_seconds = max(typed["intro_duration"], 0.0)
    if "outro_duration" in typed:
        video.outro_duration_seconds = max(typed["outro_duration"], 0.0)
    if "video_mode" in typed:
        video.mode = typed["video_mode"]
        video.mode_override = True
    # A mode other than the default set in the TOML is a choice too.
    if video.mode != d.DEFAULT_VIDEO_MODE:
        video.mode_override = True
    if config.output.log_loss and config.output.plot_losses:
        logger.warning(
            "Loss plotting is disabled because CSV logging is enabled. "
            "Only loss CSV will be created.",
        )
        config.output.plot_losses = False
    config.validate()
    return config


def _check_style_args(args: argparse.Namespace) -> list[str] | None:
    """The ``--styles`` list, after the JAX package's combination checks.

    ``None`` without ``--styles``. Raises ``SystemExit`` with the JAX
    package's message, in its order, for a blend without styles, a
    sweep with a blend or without styles, masks without styles or with
    a blend or sweep, and an empty list.
    """
    if args.style_blend and not args.styles:
        msg = "--style-blend requires --styles (the images to blend)"
        raise SystemExit(msg)
    if args.blend_sweep is not None:
        if args.style_blend:
            msg = (
                "--blend-sweep is incompatible with --style-blend "
                "(the sweep generates its own per-frame weights)"
            )
            raise SystemExit(msg)
        if not args.styles:
            msg = "--blend-sweep requires --styles (>= 2 images to morph)"
            raise SystemExit(msg)
    if args.style_masks:
        if not args.styles:
            msg = "--style-masks requires --styles (one image per mask)"
            raise SystemExit(msg)
        if args.style_blend or args.blend_sweep is not None:
            msg = (
                "--style-masks is incompatible with --style-blend/"
                "--blend-sweep (regional masks already assign styles "
                "to regions)"
            )
            raise SystemExit(msg)
    if not args.styles:
        return None
    style_paths = [s.strip() for s in args.styles.split(",") if s.strip()]
    if not style_paths:
        msg = "--styles was given but contains no paths"
        raise SystemExit(msg)
    return style_paths


def _parse_blend_weights(
    spec: str,
    style_paths: list[str],
) -> list[tuple[str, float]]:
    """Validate and normalize ``--style-blend`` into (path, weight) pairs."""
    try:
        weights = [float(w) for w in spec.split(",") if w.strip()]
    except ValueError as exc:
        msg = f"--style-blend must be comma-separated numbers: {exc}"
        raise SystemExit(msg) from exc
    if len(weights) != len(style_paths):
        msg = (
            f"--style-blend has {len(weights)} weights for "
            f"{len(style_paths)} --styles entries"
        )
        raise SystemExit(msg)
    if any(w < 0 for w in weights):
        msg = "--style-blend weights must be non-negative"
        raise SystemExit(msg)
    total = sum(weights)
    if total <= 0:
        msg = "--style-blend weights must not all be zero"
        raise SystemExit(msg)
    return [(p, w / total) for p, w in zip(style_paths, weights, strict=True)]


def _comparisons(
    args: argparse.Namespace,
    config: StyleTransferConfig,
    style_path: str,
    result_path: Path | None = None,
) -> None:
    if args.compare_inputs or args.compare_result:
        render_requested_comparisons(
            content_path=Path(args.content),
            style_path=Path(style_path),
            output_dir=Path(config.output.output),
            request=ComparisonRequest(
                include_inputs=args.compare_inputs,
                include_result=args.compare_result,
                result_path=result_path,
            ),
        )


def _run_blended(
    args: argparse.Namespace,
    config: StyleTransferConfig,
    style_blend: list[tuple[str, float]],
) -> None:
    """One interpolated stylization from weighted styles (blend mode)."""
    # The highest-weight style fronts the gallery intro/outro panels
    # and the --compare-* renders (ties resolve to the earliest).
    primary = max(style_blend, key=lambda pair: pair[1])[0]
    logger.info(
        "Blended styles: %s",
        ", ".join(f"{p} (w={w:.3f})" for p, w in style_blend),
    )
    style_transfer(
        InputPaths(args.content, primary), config, style_blend=style_blend,
    )
    joined = "+".join(Path(p).stem for p, _ in style_blend)
    _comparisons(
        args, config, primary,
        Path(config.output.output)
        / f"stylized_{Path(args.content).stem}_x_{joined}.png",
    )


def _run_regional(
    args: argparse.Namespace,
    config: StyleTransferConfig,
    style_paths: list[str],
) -> None:
    """Masked regional transfer: one style per masked region."""
    if config.hardware.spatial_shards > 1:
        msg = (
            "--spatial-shards is not supported with --style-masks "
            "(regional mode evaluates mask-weighted Grams whole-image); "
            "drop --spatial-shards for regional runs"
        )
        raise SystemExit(msg)
    mask_paths = [
        m.strip() for m in args.style_masks.split(",") if m.strip()
    ]
    logger.info(
        "Regional transfer: content=%s styles=%s masks=%s",
        args.content, style_paths, mask_paths,
    )
    result = stylize_regional(
        args.content, list(style_paths), mask_paths, config,
    )
    logger.info(
        "Regional transfer finished in %.2fs (final loss %.4g): %s",
        result.elapsed_seconds, result.final_loss, result.output_path,
    )


def _run_blend_sweep(
    args: argparse.Namespace,
    config: StyleTransferConfig,
    style_paths: list[str],
) -> None:
    """N-frame morph animation across the style list (blend sweep)."""
    logger.info(
        "Blend sweep: content=%s styles=%s frames=%d",
        args.content, style_paths, args.blend_sweep,
    )
    result = stylize_blend_sweep(
        args.content, list(style_paths), config,
        n_frames=args.blend_sweep,
        sweep_steps=args.sweep_steps,
    )
    logger.info(
        "Blend sweep finished: %d frames, %d total steps%s",
        len(result.frame_paths), result.total_steps,
        f", animation at {result.video_path}" if result.video_path else "",
    )


def main(argv: Sequence[str] | None = None) -> int:
    """Parse ``argv``, run the transfer, and return the exit code.

    ``--config`` loads a TOML (the JAX package's layout) under the typed
    flags; ``--validate-config-only`` loads it and returns 0 without
    running anything.
    """
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.validate_config_only and not args.config:
        parser.error("--validate-config-only requires --config")
    base = None
    if args.config:
        try:
            base = ConfigLoader.load(args.config)
        except (OSError, ValueError, NotImplementedError) as exc:
            parser.error(str(exc))
        if args.validate_config_only:
            logger.info("Config %s validated successfully.", args.config)
            return 0
    if not args.content or not (args.style or args.styles):
        parser.error(
            "the following arguments are required: --content, --style",
        )
    try:
        config = config_from_args(args, base)
    except ValueError as exc:
        parser.error(str(exc))
    if args.config:
        logger.info("Loaded config from: %s", args.config)
    logger.info("Matmul Precision: %s", config.hardware.precision)
    if config.hardware.spatial_shards > 1:
        logger.info("Spatial Shards: %d", config.hardware.spatial_shards)
    if config.optimization.tile_rows > 0:
        logger.info("Tile Rows: %d", config.optimization.tile_rows)
    if config.hardware.steps_per_dispatch:
        logger.info(
            "Steps per Dispatch: %d", config.hardware.steps_per_dispatch,
        )
    style_paths = _check_style_args(args)
    if style_paths is not None:
        if args.style_masks:
            _run_regional(args, config, style_paths)
            return 0
        if args.blend_sweep is not None:
            _run_blend_sweep(args, config, style_paths)
            return 0
        if not args.style_blend:
            logger.info(
                "Multi-style batch: content=%s styles=%s",
                args.content, style_paths,
            )
            multi_style_transfer(args.content, style_paths, config)
            return 0
        _run_blended(
            args, config, _parse_blend_weights(args.style_blend, style_paths),
        )
        return 0
    style_transfer(InputPaths(args.content, args.style), config)
    _comparisons(args, config, args.style)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
