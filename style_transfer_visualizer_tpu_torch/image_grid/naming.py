"""Naming and persistence for comparison outputs.

Deterministic names (``comparison_{content}_x_{style}.png``, spaces
mapped to underscores) and file-opening wrappers around the layout
renderers; the port's own copy of the JAX package's
``image_grid/naming.py``.
"""
from __future__ import annotations

from contextlib import ExitStack
from pathlib import Path
from typing import TYPE_CHECKING


from style_transfer_visualizer_tpu_torch.constants import (
    COLOR_GREY,
    COLOR_WHITE,
    RESOLUTION_FULL_HD,
)
from style_transfer_visualizer_tpu_torch.image_grid.core import (
    DEFAULT_HEIGHT,
    DEFAULT_PAD,
    RGB,
    FrameParams,
    to_rgb,
)
from style_transfer_visualizer_tpu_torch.image_grid.layouts import (
    make_gallery_comparison,
    make_horizontal_grid,
)

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.type_defs import LayoutName


def _safe_stem(p: Path) -> str:
    return p.stem.replace(" ", "_")


def _require_path(out_path: object) -> Path:
    if not isinstance(out_path, Path):
        msg = "out_path must be a pathlib.Path"
        raise TypeError(msg)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    return out_path


def default_comparison_name(
    content_path: Path,
    style_path: Path,
    out_dir: Path,
) -> Path:
    """Deterministic comparison filename from the input stems."""
    stem_c = _safe_stem(content_path)
    stem_s = _safe_stem(style_path)
    return out_dir / f"comparison_{stem_c}_x_{stem_s}.png"


def save_comparison_grid(
    content_path: Path,
    style_path: Path,
    result_path: Path,
    out_path: Path,
    *,
    target_height: int | None = DEFAULT_HEIGHT,
    target_size: tuple[int, int] | None = None,
    pad: int = DEFAULT_PAD,
    bg_color: RGB = COLOR_WHITE,
    border_px: int = 0,
) -> Path:
    """Open the three inputs, render a flat grid, save as PNG."""
    from PIL import Image  # noqa: PLC0415

    out_path = _require_path(out_path)
    with ExitStack() as stack:
        panels = [
            to_rgb(
                stack.enter_context(Image.open(p)), bg_color=bg_color,
            )
            for p in (content_path, style_path, result_path)
        ]
        make_horizontal_grid(
            panels,
            target_height=target_height,
            target_size=target_size,
            pad=pad,
            bg_color=bg_color,
            border_px=border_px,
        ).save(out_path, format="PNG")
    return out_path


def save_gallery_comparison(
    content_path: Path,
    style_path: Path,
    result_path: Path | None,
    out_path: Path,
    *,
    target_size: tuple[int, int] = RESOLUTION_FULL_HD,
    layout: LayoutName = "gallery-stacked-left",
    wall_color: RGB = COLOR_GREY,
    frame_tone: str = "gold",
    show_labels: bool = True,
) -> Path:
    """Open inputs, render a gallery wall, save as PNG."""
    from PIL import Image  # noqa: PLC0415

    out_path = _require_path(out_path)
    frame = FrameParams(
        frame_tone=frame_tone,
        label="on" if show_labels else None,
    )
    with ExitStack() as stack:
        opened = [
            stack.enter_context(Image.open(p)) if p else None
            for p in (content_path, style_path, result_path)
        ]
        make_gallery_comparison(
            content=opened[0],
            style=opened[1],
            result=opened[2],
            target_size=target_size,
            layout=layout,
            wall_color=wall_color,
            frame=frame,
        ).save(out_path, format="PNG")
    return out_path
