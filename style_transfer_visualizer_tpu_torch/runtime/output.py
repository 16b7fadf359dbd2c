"""Output directory management and the final PNG.

The port of the JAX package's ``runtime/output.py`` with final-only
semantics: canonical ``stylized_{content}_x_{style}.png`` naming and a
``style_transfer_output`` fallback directory on ``OSError``. The loss
plot and the timelapse media wait for a later slice of the port.
"""
from __future__ import annotations

from pathlib import Path

import torch

from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.utils.logging import logger

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


def stylized_image_path_from_paths(
    output_dir: Path,
    content_path: Path,
    style_path: Path,
) -> Path:
    """Canonical stylized output path derived from input file paths."""
    return output_dir / _STYLIZED_TEMPLATE.format(
        content=_canonical_stem(content_path),
        style=_canonical_stem(style_path),
    )


def save_final_image(
    image01: torch.Tensor,
    final_path: Path,
    elapsed: float,
) -> None:
    """Save a (1, H, W, 3) [0,1] image as the run's final PNG."""
    image_io.save_array_as_image(image01, final_path)
    logger.info("Style transfer completed in %.2f seconds", elapsed)
    logger.info("Final stylized image saved to: %s", final_path)
