"""Comparison-image rendering requested via the main CLI.

The port's own copy of the JAX package's ``runtime/comparison.py``:
canvas sizes follow the content image, the result variant appends
``_final`` to the deterministic name, and a missing stylized output is
skipped with a warning rather than an error. Pillow is imported inside
the function that reads the content's size.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

from style_transfer_visualizer_tpu_torch.constants import COLOR_GREY
from style_transfer_visualizer_tpu_torch.gallery import (
    ComparisonRenderOptions,
    render_comparison,
)
from style_transfer_visualizer_tpu_torch.image_grid.naming import (
    default_comparison_name,
)
from style_transfer_visualizer_tpu_torch.runtime.output import (
    stylized_image_path_from_paths,
)
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.type_defs import LayoutName

__all__ = [
    "ComparisonRequest",
    "comparison_output_path",
    "render_comparison_image",
    "render_requested_comparisons",
]

_FINAL_SUFFIX = "_final"


@dataclass(slots=True)
class ComparisonRequest:
    """Which comparison artifacts the caller wants."""

    include_inputs: bool
    include_result: bool
    result_path: Path | None = None


def comparison_output_path(
    output_dir: Path | str,
    content_path: Path,
    style_path: Path,
    *,
    include_result: bool,
) -> Path:
    """Deterministic output path; ``_final`` suffix for result variants."""
    base = default_comparison_name(
        content_path, style_path, Path(output_dir),
    )
    if not include_result:
        return base
    return base.with_name(f"{base.stem}{_FINAL_SUFFIX}{base.suffix}")


def _content_canvas_size(content_path: Path) -> tuple[int, int]:
    from PIL import Image  # noqa: PLC0415 - optional dependency

    with Image.open(content_path) as im:
        return im.size


def render_comparison_image(
    content_path: Path,
    style_path: Path,
    *,
    output_dir: Path | str,
    include_result: bool,
    result_path: Path | None = None,
) -> Path:
    """Render one gallery comparison sized to the content image."""
    content_path = Path(content_path)
    style_path = Path(style_path)

    layout: LayoutName = (
        "gallery-stacked-left" if include_result else "gallery-two-across"
    )
    options = ComparisonRenderOptions(
        content_path=content_path,
        style_path=style_path,
        result_path=(
            Path(result_path) if include_result and result_path else None
        ),
        out_path=comparison_output_path(
            output_dir, content_path, style_path,
            include_result=include_result,
        ),
        target_size=_content_canvas_size(content_path),
        layout=layout,
        wall_color=COLOR_GREY,
        frame_style="gold",
        show_labels=True,
    )
    return render_comparison(options)


def _resolve_expected_result(
    request: ComparisonRequest,
    output_dir: Path,
    content_path: Path,
    style_path: Path,
) -> Path:
    if request.result_path is not None:
        return request.result_path
    return stylized_image_path_from_paths(
        output_dir, content_path, style_path,
    )


def render_requested_comparisons(
    *,
    content_path: Path,
    style_path: Path,
    output_dir: Path | str,
    request: ComparisonRequest,
) -> list[Path]:
    """Render the requested comparisons; skip a missing stylized result."""
    output_dir = Path(output_dir)
    saved: list[Path] = []

    if request.include_inputs:
        saved.append(
            render_comparison_image(
                content_path=content_path,
                style_path=style_path,
                output_dir=output_dir,
                include_result=False,
            ),
        )

    if not request.include_result:
        return saved

    expected = _resolve_expected_result(
        request, output_dir, content_path, style_path,
    )
    if not expected.exists():
        logger.warning(
            "Expected stylized result missing: %s. "
            "Skipping content+style+result comparison.",
            expected,
        )
        return saved

    saved.append(
        render_comparison_image(
            content_path=content_path,
            style_path=style_path,
            output_dir=output_dir,
            include_result=True,
            result_path=expected,
        ),
    )
    return saved
