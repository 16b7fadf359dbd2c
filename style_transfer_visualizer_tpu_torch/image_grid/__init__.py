"""Image-grid rendering: gallery walls, framed panels, comparison grids.

Host-side Pillow compositing shared by the video intro/outro segments
and the ``--compare-*`` walls.
"""

from style_transfer_visualizer_tpu_torch.image_grid import (
    core,
    layouts,
    naming,
)
from style_transfer_visualizer_tpu_torch.image_grid.core import (
    DEFAULT_HEIGHT,
    DEFAULT_PAD,
    FrameParams,
    Rect,
    build_framed_panel,
    make_wall_canvas,
    to_rgb,
)
from style_transfer_visualizer_tpu_torch.image_grid.layouts import (
    make_gallery_comparison,
    make_horizontal_grid,
)
from style_transfer_visualizer_tpu_torch.image_grid.naming import (
    default_comparison_name,
    save_comparison_grid,
    save_gallery_comparison,
)

__all__ = [
    "DEFAULT_HEIGHT",
    "DEFAULT_PAD",
    "FrameParams",
    "Rect",
    "build_framed_panel",
    "core",
    "default_comparison_name",
    "layouts",
    "make_gallery_comparison",
    "make_horizontal_grid",
    "make_wall_canvas",
    "naming",
    "save_comparison_grid",
    "save_gallery_comparison",
    "to_rgb",
]
