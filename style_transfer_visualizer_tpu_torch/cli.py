"""Command line of the port: one content image, one style image.

    python -m style_transfer_visualizer_tpu_torch.cli \\
        --content c.png --style s.png --steps 300 --device cuda

Only the flags this slice of the port supports exist; the output is
the final PNG (no timelapse).
"""
from __future__ import annotations

import argparse
from collections.abc import Sequence

from style_transfer_visualizer_tpu_torch import config_defaults as d
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.main import style_transfer
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths


def _int_list(text: str) -> list[int]:
    return [int(part) for part in text.split(",")]


def build_parser() -> argparse.ArgumentParser:
    """The argument parser of the port's CLI."""
    p = argparse.ArgumentParser(
        prog="style_transfer_visualizer_tpu_torch.cli",
        description="Neural style transfer on PyTorch/CUDA (L-BFGS).",
    )
    p.add_argument("--content", required=True, help="content image file")
    p.add_argument("--style", required=True, help="style image file")
    p.add_argument("--output", default=d.DEFAULT_OUTPUT_DIR)
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
    p.add_argument("--log-every", type=int, default=d.DEFAULT_LOG_EVERY)
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
    return p


def config_from_args(args: argparse.Namespace) -> StyleTransferConfig:
    """Build the validated config from parsed arguments."""
    return StyleTransferConfig(
        output=OutputConfig(output=args.output, log_every=args.log_every),
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
        hardware=HardwareConfig(device=args.device),
    )


def main(argv: Sequence[str] | None = None) -> int:
    """Parse ``argv``, run the transfer, and return the exit code."""
    args = build_parser().parse_args(argv)
    try:
        config = config_from_args(args)
    except ValueError as exc:
        build_parser().error(str(exc))
    style_transfer(InputPaths(args.content, args.style), config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
