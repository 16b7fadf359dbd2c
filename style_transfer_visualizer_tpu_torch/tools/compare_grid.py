"""The ``compare-grid`` tool path of the port (``tools/compare_grid.py``).

    python -m style_transfer_visualizer_tpu_torch.tools.compare_grid ...

Scripts that import the tool path get the gallery CLI and its
validators, as the JAX package's shim gives them.
"""
from __future__ import annotations

from style_transfer_visualizer_tpu_torch.gallery import (
    parse_wall_color as _parse_hex_color,
    positive_int,
    size_2d,
)
from style_transfer_visualizer_tpu_torch.gallery.cli import build_parser, main

__all__ = [
    "_parse_hex_color",
    "build_parser",
    "main",
    "positive_int",
    "size_2d",
]


if __name__ == "__main__":
    raise SystemExit(main())
