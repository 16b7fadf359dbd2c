"""``style-sequence-torch``: stylize a directory of video frames or a clip.

The port of the JAX package's ``sequence_cli.py``, with its flags,
names and help:

    python -m style_transfer_visualizer_tpu_torch.sequence_cli \\
        --frames frames/ --style s.png --steps 100 --gif

``--config`` loads a TOML in the JAX package's layout under the typed
flags (a flag the user did not type is absent, ``argparse.SUPPRESS``),
as ``cli.py`` does. ``--precision`` takes the four tiers;
``--spatial-shards N`` splits each frame's rows over N processes
(``parallel/spatial.py``), one card each.
The run is ``sequence.stylize_sequence`` on ``--device`` (``cuda`` by
default).
"""
from __future__ import annotations

import argparse
import sys
from collections.abc import Sequence

from style_transfer_visualizer_tpu_torch.cli import (
    _float_list,
    _int_list,
    _parse_blend_weights,
    config_from_args,
)
from style_transfer_visualizer_tpu_torch.config import ConfigLoader
from style_transfer_visualizer_tpu_torch.ops.precision import PRECISION_NAMES
from style_transfer_visualizer_tpu_torch.sequence import stylize_sequence
from style_transfer_visualizer_tpu_torch.utils.logging import logger


def build_parser() -> argparse.ArgumentParser:
    """Build the sequence-stylization argument parser."""
    s = argparse.SUPPRESS
    p = argparse.ArgumentParser(
        prog="style-sequence-torch",
        description=(
            "Stylize an image sequence (video frames) with per-frame "
            "warm starting for temporal coherence."
        ),
    )
    p.add_argument(
        "--frames", required=True, type=str,
        help="Directory of input frames (png/jpg), processed in name "
             "order — or a video clip file (.gif/.webp decode via "
             "Pillow; .mp4/.mov/.mkv/.webm/.avi via ffmpeg), decoded "
             "into frames first.",
    )
    p.add_argument("--style", type=str, help="Path to style image")
    p.add_argument(
        "--styles", type=str, default=None,
        help="Comma-separated style images for a blended sequence "
             "(requires --style-blend; replaces --style)",
    )
    p.add_argument(
        "--style-blend", dest="style_blend", type=str, default=None,
        help="Comma-separated non-negative weights, one per --styles "
             "entry; the clip optimizes against the weighted Gram "
             "mixture of the styles (weights are normalized to sum 1)",
    )
    p.add_argument(
        "--output", type=str, default=s,
        help="Output directory for stylized frames",
    )
    p.add_argument(
        "--steps", type=int, default=s,
        help="Optimization steps per frame (default from config: 1500; "
             "sequences usually want far fewer, e.g. 50-200)",
    )
    p.add_argument("--style-w", type=float, default=s)
    p.add_argument("--content-w", type=float, default=s)
    p.add_argument(
        "--tv-w", dest="tv_w", type=float, default=s,
        help="Total-variation weight: smoothness regularizer on each "
             "stylized frame (0, the default, is style+content only)",
    )
    p.add_argument(
        "--lap-w", dest="lap_w", type=float, default=s,
        help="Laplacian detail-preservation weight (Lapstyle): pins "
             "each frame's edge structure to its OWN source frame "
             "(0, the default, is style+content only)",
    )
    p.add_argument(
        "--lap-pool", dest="lap_pool", type=int, default=s,
        help="Mean-pool size before the Laplacian stencil (default 4)",
    )
    p.add_argument("--lr", type=float, default=s)
    p.add_argument("--optimizer", choices=["lbfgs", "adam"], default=s)
    p.add_argument(
        "--model", choices=["vgg19", "vgg16"], default=s,
        help="Feature backbone (default: vgg19; see style-visualizer help)",
    )
    p.add_argument(
        "--lbfgs-history-size", dest="lbfgs_history_size", type=int,
        default=s,
        help="L-BFGS curvature-pair history length (default 100)",
    )
    p.add_argument(
        "--lbfgs-history-dtype", dest="lbfgs_history_dtype",
        choices=["float32", "bfloat16"], default=s,
        help="Storage dtype for the L-BFGS curvature ring",
    )
    p.add_argument(
        "--lbfgs-direction", dest="lbfgs_direction",
        choices=["two-loop", "compact"], default=s,
        help="L-BFGS direction algorithm (see style-visualizer --help)",
    )
    p.add_argument(
        "--init-method", choices=["random", "white", "content"], default=s,
        help="Initialization for the FIRST frame (later frames warm-start)",
    )
    p.add_argument(
        "--preserve-color", dest="preserve_color",
        choices=["off", "luminance", "match"], default=s,
        help="Keep the clip's colors: 'luminance' recolors each "
             "stylized frame with its own source frame's chrominance; "
             "'match' remaps the style(s) onto frame 0's color "
             "statistics before targets (see style-visualizer --help)",
    )
    p.add_argument("--seed", type=int, default=s)
    p.add_argument(
        "--coarse-steps", dest="coarse_steps", type=int, default=s,
        help="Warm-start frame 0 with N half-resolution steps "
             "(later frames warm from the previous result).",
    )
    p.add_argument("--no-normalize", action="store_true", default=s)
    p.add_argument(
        "--style-layers", dest="style_layers", type=_int_list, default=s,
        help="Comma-separated layer indices for the style loss",
    )
    p.add_argument(
        "--content-layers", dest="content_layers", type=_int_list,
        default=s,
        help="Comma-separated layer indices for the content loss",
    )
    p.add_argument(
        "--style-layer-weights", dest="style_layer_weights",
        type=_float_list, default=s,
        help="Comma-separated per-layer style weights (one per "
             "--style-layers entry); omit for equal weighting",
    )
    p.add_argument("--device", type=str, default=s)
    p.add_argument(
        "--spatial-shards", dest="spatial_shards", type=int, default=s,
        help="Shard each frame's rows over N processes, one card each "
             "(halo-exchange convs, Gram partials summed over NCCL); "
             "frame heights must divide N * 2^pools (see "
             "style-visualizer-torch --help)",
    )
    p.add_argument(
        "--precision", choices=list(PRECISION_NAMES), default=s,
        help="Matmul precision tier of the kernels on the card (see "
             "style-visualizer-torch --help; 'mixed' is the "
             "curve-parity default)",
    )
    p.add_argument("--allow-random-weights", action="store_true", default=s)
    p.add_argument(
        "--gif", action="store_true",
        help="Assemble stylized frames into stylized_sequence.gif",
    )
    p.add_argument(
        "--output-video", dest="output_video", type=str, default=None,
        help="Assemble stylized frames into this clip file under the "
             "output directory (.gif, or .mp4/.mov/.mkv/.webm with "
             "ffmpeg on PATH). Defaults its frame rate to the source "
             "clip's when --frames is a video file.",
    )
    p.add_argument(
        "--max-frames", dest="max_frames", type=int, default=None,
        help="Stylize at most N frames (applied after --frame-stride)",
    )
    p.add_argument(
        "--frame-stride", dest="frame_stride", type=int, default=1,
        help="Keep every Nth source frame (temporal downsampling)",
    )
    p.add_argument(
        "--fps", type=int, default=s,
        help="Frame rate for --gif/--output-video assembly (default 10; "
             "video-file input defaults --output-video to the source "
             "rate instead)",
    )
    p.add_argument("--config", type=str, help="Path to config.toml")
    return p


def _style_choice(
    args: argparse.Namespace,
) -> tuple[str, list[tuple[str, float]] | None]:
    """``(primary style, blend pairs or None)``, the JAX checks first."""
    if args.styles:
        if not args.style_blend:
            msg = "--styles requires --style-blend (the mixture weights)"
            raise SystemExit(msg)
        if args.style:
            msg = "--style and --styles are mutually exclusive"
            raise SystemExit(msg)
        style_paths = [p for p in args.styles.split(",") if p.strip()]
        style_blend = _parse_blend_weights(args.style_blend, style_paths)
        logger.info(
            "Blended styles: %s",
            ", ".join(f"{p} (w={w:.3f})" for p, w in style_blend),
        )
        # The highest-weight style is the primary (ties: the earliest).
        return max(style_blend, key=lambda pair: pair[1])[0], style_blend
    if args.style_blend:
        msg = "--style-blend requires --styles (the images to blend)"
        raise SystemExit(msg)
    if args.style:
        return args.style, None
    msg = "one of --style or --styles is required"
    raise SystemExit(msg)


def main(argv: Sequence[str] | None = None) -> int:
    """Entry point of ``style-sequence-torch``; returns the exit code."""
    parser = build_parser()
    args = parser.parse_args(argv)
    style_path, style_blend = _style_choice(args)
    typed = vars(args)
    try:
        base = ConfigLoader.load(args.config) if args.config else None
        config = config_from_args(args, base)
    except (OSError, ValueError, NotImplementedError) as exc:
        parser.error(str(exc))
    # An explicit --fps sets the assembly rate; otherwise a clip input
    # keeps its own rate (argparse.SUPPRESS keeps the difference).
    explicit_fps = typed.get("fps")
    result = stylize_sequence(
        args.frames, style_path, config, config.output.output,
        assemble_gif=args.gif,
        style_blend=style_blend,
        output_video=args.output_video,
        output_fps=float(explicit_fps) if explicit_fps else None,
        max_frames=args.max_frames,
        frame_stride=args.frame_stride,
    )
    logger.info(
        "Sequence complete: %d frames, %d total steps.",
        len(result.frame_paths), result.total_steps,
    )
    return 0


def entrypoint() -> None:
    """Console-script entry."""
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
