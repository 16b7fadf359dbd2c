"""Output directory management and final artifact persistence.

The port of the JAX package's ``runtime/output.py``: canonical
``stylized_{content}_x_{style}.png`` naming, a ``style_transfer_output``
fallback directory on ``OSError``, the final PNG, the saved-media log
lines and the loss plot (matplotlib imported only when plotting).
"""
from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.ops.color import maybe_restore_color
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu_torch.visualization.metrics import (
    plot_loss_curves,
)

if TYPE_CHECKING:
    import torch

    from style_transfer_visualizer_tpu_torch.type_defs import (
        LossHistory,
        SaveOptions,
    )

_FALLBACK_DIR = "style_transfer_output"
_STYLIZED_TEMPLATE = "stylized_{content}_x_{style}.png"


def setup_output_directory(output_path: str) -> Path:
    """Create (or fall back from) the requested output directory."""
    resolved = Path(output_path)
    try:
        resolved.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        logger.error("Failed to create output directory: %s", exc)
        resolved = Path(_FALLBACK_DIR)
        resolved.mkdir(parents=True, exist_ok=True)
        logger.info("Using fallback directory: %s", resolved)
    return resolved


def _canonical_stem(path: Path) -> str:
    """Filesystem-safe stem: spaces become underscores."""
    return path.stem.replace(" ", "_")


def stylized_image_path_from_names(
    output_dir: Path,
    content_name: str,
    style_name: str,
) -> Path:
    """Canonical stylized output path for content/style stems."""
    return output_dir / _STYLIZED_TEMPLATE.format(
        content=content_name, style=style_name,
    )


def stylized_image_path_from_paths(
    output_dir: Path,
    content_path: Path,
    style_path: Path,
) -> Path:
    """Canonical stylized output path derived from input file paths."""
    return stylized_image_path_from_names(
        output_dir, _canonical_stem(content_path), _canonical_stem(style_path),
    )


def save_outputs(
    input_img: torch.Tensor,
    loss_metrics: LossHistory,
    output_dir: Path,
    elapsed: float,
    opts: SaveOptions,
) -> None:
    """Persist the final image, optional loss plot, and summary logs.

    With ``opts.chroma_source`` the PNG keeps the content's chrominance.
    """
    output_dir = setup_output_directory(str(output_dir))
    final_path = stylized_image_path_from_names(
        output_dir, opts.content_name, opts.style_name,
    )
    final_img = maybe_restore_color(
        image_io.prepare_image_for_output(input_img, normalize=opts.normalize),
        opts.chroma_source,
    )
    image_io.save_array_as_image(final_img, final_path)

    if opts.video_created and opts.video_name:
        logger.info("Video saved to: %s", output_dir / opts.video_name)
    if opts.gif_created and opts.gif_name:
        gif_path = output_dir / opts.gif_name
        if gif_path.exists():
            logger.info("GIF saved to: %s", gif_path)

    if opts.plot_losses:
        plot_loss_curves(loss_metrics, output_dir)

    logger.info("Style transfer completed in %.2f seconds", elapsed)
    logger.info("Final stylized image saved to: %s", final_path)
