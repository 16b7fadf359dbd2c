"""Public gallery rendering API."""

from style_transfer_visualizer_tpu_torch.gallery.api import (
    FRAME_CHOICES,
    LAYOUT_CHOICES,
    ComparisonRenderOptions,
    FrameStyle,
    GalleryLayout,
    parse_wall_color,
    positive_int,
    render_comparison,
    size_2d,
)

__all__ = [
    "FRAME_CHOICES",
    "LAYOUT_CHOICES",
    "ComparisonRenderOptions",
    "FrameStyle",
    "GalleryLayout",
    "parse_wall_color",
    "positive_int",
    "render_comparison",
    "size_2d",
]
