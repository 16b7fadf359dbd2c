"""Command line of the port: one content image, one style image.

    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --style s.png --steps 300 --device cuda

The flags the port supports carry the JAX package's names and defaults:
the optimization flags of the main path, and the output and video flags
of the timelapse (``--save-every``, ``--no-video``, ``--gif``,
``--log-loss``, ``--compare-inputs`` and the rest). A realtime or
postprocess MP4 needs ``ffmpeg`` on PATH; the GIF needs imageio.
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
from style_transfer_visualizer_tpu_torch.main import style_transfer
from style_transfer_visualizer_tpu_torch.runtime.comparison import (
    ComparisonRequest,
    render_requested_comparisons,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils.logging import logger


def _int_list(text: str) -> list[int]:
    return [int(part) for part in text.split(",")]


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
        help="use seeded random VGG19 weights when none are found",
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
        description="Neural style transfer on PyTorch/CUDA (L-BFGS).",
    )
    p.add_argument("--content", required=True, help="content image file")
    p.add_argument("--style", required=True, help="style image file")
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
            lr=args.lr,
            init_method=args.init_method,
            seed=args.seed,
            normalize=not args.no_normalize,
            style_layers=args.style_layers,
            content_layers=args.content_layers,
            lbfgs_history_size=args.lbfgs_history_size,
            lbfgs_history_dtype=args.lbfgs_history_dtype,
            lbfgs_direction=args.lbfgs_direction,
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


def main(argv: Sequence[str] | None = None) -> int:
    """Parse ``argv``, run the transfer, and return the exit code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        config = config_from_args(args)
    except ValueError as exc:
        parser.error(str(exc))
    style_transfer(InputPaths(args.content, args.style), config)
    if args.compare_inputs or args.compare_result:
        render_requested_comparisons(
            content_path=Path(args.content),
            style_path=Path(args.style),
            output_dir=Path(config.output.output),
            request=ComparisonRequest(
                include_inputs=args.compare_inputs,
                include_result=args.compare_result,
            ),
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
