"""``compare-grid-torch``: the JAX package's ``compare-grid`` in the port.

    python -m style_transfer_visualizer_tpu_torch.gallery.cli \\
        --content c.png --style s.png --result r.png --out wall.png \\
        [--layout gallery-two-across] [--show-labels]

The same flags, from the same data-driven table, render the same
comparison grid or gallery wall through the port's ``gallery.api``;
validators that raise ``ValueError`` become argparse type errors.
"""
from __future__ import annotations

import argparse
from collections.abc import Callable, Sequence
from pathlib import Path
from typing import Any, TypeVar

from style_transfer_visualizer_tpu_torch.gallery.api import (
    FRAME_CHOICES,
    LAYOUT_CHOICES,
    ComparisonRenderOptions,
    parse_wall_color,
    positive_int,
    render_comparison,
    size_2d,
)

T = TypeVar("T")


def _argtype(validator: Callable[[str], T]) -> Callable[[str], T]:
    """Adapt a ValueError-raising validator to argparse conventions."""

    def wrapper(text: str) -> T:
        try:
            return validator(text)
        except ValueError as exc:
            raise argparse.ArgumentTypeError(str(exc)) from exc

    return wrapper


# (flag, kwargs) rows; callables in "type" are wrapped for argparse.
_ARG_TABLE: tuple[tuple[str, dict[str, Any]], ...] = (
    ("--content", {"required": True, "type": Path}),
    ("--style", {"required": True, "type": Path}),
    ("--result", {"required": False, "type": Path}),
    ("--out", {"type": Path, "default": None}),
    ("--target-height", {"type": _argtype(positive_int), "default": 512}),
    ("--pad", {"type": _argtype(positive_int), "default": 16}),
    ("--border-px", {"type": _argtype(positive_int), "default": 0}),
    ("--target-size", {
        "type": _argtype(size_2d),
        "default": None,
        "help": "Exact WxH for video safe output, e.g., 1920x1080.",
    }),
    ("--layout", {
        "type": str,
        "default": None,
        "choices": list(LAYOUT_CHOICES),
        "help": (
            "If provided, render as a gallery wall. "
            "Select two or three panel layout."
        ),
    }),
    ("--wall", {
        "type": str,
        "default": "#3c434a",
        "help": "Wall color as hex like #3c434a.",
    }),
    ("--frame-style", {
        "type": str,
        "default": "gold",
        "choices": list(FRAME_CHOICES),
        "help": "Quick frame tone preset.",
    }),
    ("--show-labels", {
        "action": "store_true",
        "help": "Draw Content, Style, and Final labels.",
    }),
)


def build_parser() -> argparse.ArgumentParser:
    """Build the compare-grid argument parser from the flag table."""
    parser = argparse.ArgumentParser(
        prog="compare-grid-torch",
        description=(
            "Build a 3-panel comparison from content, style, and result. "
            "Optionally render as a framed gallery wall."
        ),
    )
    for flag, kwargs in _ARG_TABLE:
        parser.add_argument(flag, **kwargs)
    return parser


def main(argv: Sequence[str] | None = None) -> int:
    """Parse arguments and render the requested comparison."""
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.layout is None and args.result is None:
        parser.error("result is required when not using gallery layout")

    options = ComparisonRenderOptions(
        content_path=args.content,
        style_path=args.style,
        result_path=args.result,
        out_path=args.out,
        target_height=args.target_height,
        pad=args.pad,
        border_px=args.border_px,
        target_size=args.target_size,
        layout=args.layout,
        wall_color=parse_wall_color(args.wall),
        frame_style=args.frame_style,
        show_labels=args.show_labels,
    )

    try:
        render_comparison(options)
    except ValueError as exc:
        parser.error(str(exc))
    return 0


def entrypoint() -> None:
    """Console-script entry."""
    raise SystemExit(main())


if __name__ == "__main__":
    entrypoint()
