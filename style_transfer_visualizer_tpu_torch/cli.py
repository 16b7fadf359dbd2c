"""Command line of the port: one content image, one style, a blend or
the multi-style batch.

    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --style s.png --steps 300 --device cuda
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png --style-blend 0.7,0.3
    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --styles s1.png,s2.png

The flags the port supports carry the JAX package's names and defaults:
the optimization flags of the single run (the optimizer, the TV and
Laplacian terms, per-layer style weights, color preservation, the
model, the coarse warm start), the style blend, and the output and
video flags of the timelapse (``--save-every``, ``--no-video``,
``--gif``, ``--log-loss``, ``--compare-inputs`` and the rest). A
realtime or postprocess MP4 needs ``ffmpeg`` on PATH; the GIF needs
imageio. ``--styles`` without ``--style-blend`` is the JAX package's
per-style batch: one stylization per style, all in one stacked step
(``main.multi_style_transfer``).
"""
from __future__ import annotations

import argparse
from collections.abc import Sequence
from pathlib import Path

from style_transfer_visualizer_tpu_torch import config_defaults as d
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.main import (
    multi_style_transfer,
    style_transfer,
)
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
    p.add_argument("--steps", type=int, default=d.DEFAULT_STEPS)
    p.add_argument("--device", default=d.DEFAULT_DEVICE)
    p.add_argument("--seed", type=int, default=d.DEFAULT_SEED)
    p.add_argument("--lr", type=float, default=d.DEFAULT_LEARNING_RATE)
    p.add_argument(
        "--style-w", type=float, default=d.DEFAULT_STYLE_WEIGHT,
    )
    p.add_argument(
        "--content-w", type=float, default=d.DEFAULT_CONTENT_WEIGHT,
    )
    p.add_argument(
        "--tv-w", type=float, default=d.DEFAULT_TV_WEIGHT,
        help=(
            "Total-variation weight: adds a smoothness regularizer on "
            "the optimized image to the objective (0, the default, "
            "leaves the style+content loss alone). Computed in the "
            "model's working space; the coarse warm start uses it too."
        ),
    )
    p.add_argument(
        "--lap-w", type=float, default=d.DEFAULT_LAP_WEIGHT,
        help=(
            "Laplacian detail-preservation weight (Lapstyle, Li et al. "
            "2017): penalizes edge-structure drift from the content "
            "photo via pooled-Laplacian response matching (0, the "
            "default, leaves the style+content loss alone)."
        ),
    )
    p.add_argument(
        "--lap-pool", type=int, default=d.DEFAULT_LAP_POOL,
        help=(
            "Mean-pool size before the Laplacian stencil (default 4): "
            "larger values match coarser edge structure and cost less."
        ),
    )
    p.add_argument(
        "--preserve-color", default=d.DEFAULT_PRESERVE_COLOR,
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
        "--init-method", default=d.DEFAULT_INIT_METHOD,
        choices=("content", "random", "white"),
    )
    p.add_argument(
        "--style-layers", type=_int_list,
        default=list(d.DEFAULT_STYLE_LAYERS),
    )
    p.add_argument(
        "--content-layers", type=_int_list,
        default=list(d.DEFAULT_CONTENT_LAYERS),
    )
    p.add_argument(
        "--style-layer-weights", type=_float_list, default=None,
        help=(
            "Comma-separated per-layer style weights (one per "
            "--style-layers entry, e.g. '1,1,0.5,0.25,0.25'); each "
            "layer's Gram MSE scales by its weight before the style "
            "sum. Omit for equal weighting."
        ),
    )
    p.add_argument(
        "--optimizer", default=d.DEFAULT_OPTIMIZER,
        choices=("lbfgs", "adam"),
        help="Pixel optimizer (default: lbfgs)",
    )
    p.add_argument(
        "--model", default=d.DEFAULT_MODEL, choices=("vgg19", "vgg16"),
        help=(
            "Feature backbone (default: vgg19). With vgg16, layer lists "
            "left at the VGG19 defaults remap to vgg16's own standard "
            "taps (style 0,5,10,17,24; content 19); explicit "
            "--style-layers/--content-layers are used as given."
        ),
    )
    p.add_argument(
        "--coarse-steps", type=int, default=d.DEFAULT_COARSE_STEPS,
        help=(
            "Warm start: optimize N steps at half resolution and "
            "upsample the result as the starting image. -1 = auto "
            "(default): on for >=1MP content with a steps/5 budget. "
            "0 disables."
        ),
    )
    p.add_argument(
        "--pyramid-levels", type=int, default=d.DEFAULT_PYRAMID_LEVELS,
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
        default=d.DEFAULT_LBFGS_HISTORY_SIZE,
    )
    p.add_argument(
        "--lbfgs-history-dtype", default=d.DEFAULT_LBFGS_HISTORY_DTYPE,
        choices=("float32", "bfloat16"),
    )
    p.add_argument(
        "--lbfgs-direction", default=d.DEFAULT_LBFGS_DIRECTION,
        choices=("two-loop", "compact"),
    )
    p.add_argument(
        "--allow-random-weights", action="store_true",
        help="use seeded random VGG weights when none are found",
    )


def _add_output_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--output", default=d.DEFAULT_OUTPUT_DIR)
    p.add_argument(
        "--log-every", type=int, default=d.DEFAULT_LOG_EVERY,
        help="loss sync cadence, and CSV row cadence with --log-loss",
    )
    p.add_argument(
        "--no-plot", action="store_true", help="Disable loss plotting",
    )
    p.add_argument(
        "--log-loss", default=None,
        help=(
            "Path to a CSV file for the loss metrics. The series then "
            "goes to disk instead of memory, and the loss plot is off."
        ),
    )
    p.add_argument(
        "--compare-inputs", action="store_true",
        help="Save a labeled comparison image of content and style.",
    )
    p.add_argument(
        "--compare-result", action="store_true",
        help=(
            "Save a labeled comparison image of content, style and "
            "the stylized result."
        ),
    )


def _add_video_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--save-every", type=int, default=d.DEFAULT_SAVE_EVERY,
        help="Save a timelapse frame every N steps",
    )
    p.add_argument(
        "--fps", type=int, default=d.DEFAULT_FPS,
        help="Frames per second for video",
    )
    p.add_argument(
        "--quality", type=int, default=d.DEFAULT_VIDEO_QUALITY,
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
        default=d.DEFAULT_VIDEO_INTRO_DURATION,
        help="Seconds to hold the intro comparison frame",
    )
    p.add_argument(
        "--no-final-frame-compare", dest="final_frame_compare",
        action="store_false",
        help="End the timelapse on the last stylization step",
    )
    p.add_argument(
        "--outro-duration", type=float,
        default=d.DEFAULT_VIDEO_OUTRO_DURATION,
        help="Seconds to hold the final comparison frame",
    )
    p.add_argument("--metadata-title", default=None)
    p.add_argument("--metadata-artist", default=None)
    p.add_argument(
        "--gif", dest="create_gif", action="store_true",
        default=d.DEFAULT_CREATE_GIF,
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
        "--video-mode", default=None, choices=("realtime", "postprocess"),
        help=(
            "realtime streams frames into ffmpeg, postprocess encodes "
            "after the optimization. When omitted, long runs may switch "
            "to postprocess."
        ),
    )


def build_parser() -> argparse.ArgumentParser:
    """The argument parser of the port's CLI."""
    p = argparse.ArgumentParser(
        prog="style_transfer_visualizer_tpu_torch.cli",
        description="Neural style transfer on PyTorch/CUDA.",
    )
    p.add_argument("--content", required=True, help="content image file")
    p.add_argument("--style", default=None, help="style image file")
    p.add_argument(
        "--styles", default=None,
        help=(
            "Comma-separated style image paths; with --style-blend, "
            "one stylization from their blended Gram targets (the "
            "per-style batch without --style-blend is not ported)."
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
    _add_optimization_flags(p)
    _add_output_flags(p)
    _add_video_flags(p)
    return p


def config_from_args(args: argparse.Namespace) -> StyleTransferConfig:
    """Build the validated config from parsed arguments."""
    plot_losses = not args.no_plot
    if args.log_loss and plot_losses:
        logger.warning(
            "Loss plotting is disabled because CSV logging is enabled. "
            "Only loss CSV will be created.",
        )
        plot_losses = False
    return StyleTransferConfig(
        output=OutputConfig(
            output=args.output,
            log_every=args.log_every,
            log_loss=args.log_loss,
            plot_losses=plot_losses,
        ),
        optimization=OptimizationConfig(
            steps=args.steps,
            style_w=args.style_w,
            content_w=args.content_w,
            tv_w=args.tv_w,
            lap_w=args.lap_w,
            lap_pool=args.lap_pool,
            preserve_color=args.preserve_color,
            lr=args.lr,
            init_method=args.init_method,
            seed=args.seed,
            normalize=not args.no_normalize,
            style_layers=args.style_layers,
            content_layers=args.content_layers,
            lbfgs_history_size=args.lbfgs_history_size,
            lbfgs_history_dtype=args.lbfgs_history_dtype,
            lbfgs_direction=args.lbfgs_direction,
            style_layer_weights=args.style_layer_weights,
            model=args.model,
            optimizer=args.optimizer,
            coarse_steps=args.coarse_steps,
            pyramid_levels=args.pyramid_levels,
            allow_random_weights=args.allow_random_weights,
        ),
        video=VideoConfig(
            save_every=args.save_every,
            fps=args.fps,
            quality=args.quality,
            create_video=not args.no_video,
            final_only=args.final_only,
            intro_enabled=not args.no_intro,
            intro_duration_seconds=max(args.intro_duration, 0.0),
            metadata_title=args.metadata_title,
            metadata_artist=args.metadata_artist,
            final_frame_compare=args.final_frame_compare,
            outro_duration_seconds=max(args.outro_duration, 0.0),
            mode=args.video_mode or d.DEFAULT_VIDEO_MODE,
            create_gif=args.create_gif,
            gif_include_intro=args.gif_include_intro,
            gif_include_outro=args.gif_include_outro,
            mode_override=args.video_mode is not None,
        ),
        hardware=HardwareConfig(device=args.device),
    )


def _check_style_args(args: argparse.Namespace) -> list[str] | None:
    """The ``--styles`` list, after the JAX package's combination checks.

    ``None`` without ``--styles``. Raises ``SystemExit`` with the JAX
    package's message for a blend without styles or an empty list.
    """
    if args.style_blend and not args.styles:
        msg = "--style-blend requires --styles (the images to blend)"
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


def main(argv: Sequence[str] | None = None) -> int:
    """Parse ``argv``, run the transfer, and return the exit code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if not (args.style or args.styles):
        parser.error("the following arguments are required: --style")
    try:
        config = config_from_args(args)
    except ValueError as exc:
        parser.error(str(exc))
    style_paths = _check_style_args(args)
    if style_paths is not None:
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
