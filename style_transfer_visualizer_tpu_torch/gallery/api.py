"""Comparison rendering API shared by the CLI, tools, and the pipeline.

One entry point (``render_comparison``) dispatches between the flat
three-panel grid (no layout given, result required) and the gallery-wall
layouts; validators parse CLI-style option strings. The port's own copy
of the JAX package's ``gallery/api.py`` (same option names, defaults,
and error wording).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

from style_transfer_visualizer_tpu_torch.constants import (
    COLOR_GREY,
    RESOLUTION_FULL_HD,
)
from style_transfer_visualizer_tpu_torch.image_grid import (
    default_comparison_name,
    save_comparison_grid,
    save_gallery_comparison,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

GalleryLayout = Literal["gallery-stacked-left", "gallery-two-across"]
FrameStyle = Literal["gold", "oak", "black"]

LAYOUT_CHOICES: tuple[GalleryLayout, ...] = (
    "gallery-stacked-left",
    "gallery-two-across",
)
FRAME_CHOICES: tuple[FrameStyle, ...] = ("gold", "oak", "black")

_SIZE_RE = re.compile(r"^(\d+)x(\d+)$")
_HEX_RE = re.compile(r"^([0-9a-fA-F]{2})([0-9a-fA-F]{2})([0-9a-fA-F]{2})$")


@dataclass(slots=True)
class ComparisonRenderOptions:
    """All knobs for one comparison render (mirrors compare-grid flags)."""

    content_path: Path
    style_path: Path
    result_path: Path | None = None
    out_path: Path | None = None
    target_height: int = 512
    pad: int = 16
    border_px: int = 0
    target_size: tuple[int, int] | None = None
    layout: GalleryLayout | None = None
    wall_color: tuple[int, int, int] = COLOR_GREY
    frame_style: FrameStyle = "gold"
    show_labels: bool = False


# --- option-string validators -------------------------------------------

def positive_int(text: str) -> int:
    """Parse a strictly positive integer."""
    try:
        value = int(text)
    except ValueError as exc:
        msg = "must be an integer"
        raise ValueError(msg) from exc
    if value <= 0:
        msg = "must be positive"
        raise ValueError(msg)
    return value


def size_2d(text: str) -> tuple[int, int]:
    """Parse a "WxH" size string."""
    match = _SIZE_RE.match(text.strip().lower())
    if match is None:
        if text.lower().count("x") == 1:
            msg = "width and height must be integers"
        else:
            msg = "must look like WxH, e.g., 1920x1080"
        raise ValueError(msg)
    width, height = int(match.group(1)), int(match.group(2))
    if width <= 0 or height <= 0:
        msg = "width and height must be positive"
        raise ValueError(msg)
    return width, height


def parse_wall_color(text: str) -> tuple[int, int, int]:
    """Parse a "#rrggbb" hex color."""
    digits = text.strip().lstrip("#")
    if len(digits) != 6:
        msg = "wall color must look like #rrggbb"
        raise ValueError(msg)
    match = _HEX_RE.match(digits)
    if match is None:
        msg = "wall color contains invalid hex digits"
        raise ValueError(msg)
    red, green, blue = (int(match.group(i), 16) for i in (1, 2, 3))
    return red, green, blue


# --- rendering dispatch --------------------------------------------------

def _with_png_suffix(path: Path) -> Path:
    return path if path.suffix.lower() == ".png" else path.with_suffix(".png")


def _render_grid(options: ComparisonRenderOptions, out_path: Path) -> Path:
    result_path = options.result_path
    if result_path is None:
        msg = "result_path is required when layout is None"
        raise ValueError(msg)
    # An exact canvas size supersedes the height-normalized layout.
    height = options.target_height if options.target_size is None else None
    return save_comparison_grid(
        content_path=Path(options.content_path),
        style_path=Path(options.style_path),
        result_path=Path(result_path),
        out_path=out_path,
        target_height=height,
        target_size=options.target_size,
        pad=options.pad,
        border_px=options.border_px,
    )


def _render_wall(options: ComparisonRenderOptions, out_path: Path) -> Path:
    # Two-across ignores any provided result by design.
    result = (
        None
        if options.layout == "gallery-two-across" or not options.result_path
        else Path(options.result_path)
    )
    return save_gallery_comparison(
        content_path=Path(options.content_path),
        style_path=Path(options.style_path),
        result_path=result,
        out_path=out_path,
        target_size=options.target_size or RESOLUTION_FULL_HD,
        layout=options.layout,
        wall_color=options.wall_color,
        frame_tone=options.frame_style,
        show_labels=options.show_labels,
    )


def render_comparison(options: ComparisonRenderOptions) -> Path:
    """Render either a flat grid or a gallery wall; return the saved path."""
    out_path = _with_png_suffix(
        Path(options.out_path)
        if options.out_path is not None
        else default_comparison_name(
            Path(options.content_path), Path(options.style_path), Path(),
        ),
    )

    renderer = _render_grid if options.layout is None else _render_wall
    saved = renderer(options, out_path)
    logger.info("Comparison image saved to: %s", saved)
    return saved
