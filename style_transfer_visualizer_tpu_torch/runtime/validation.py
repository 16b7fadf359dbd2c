"""Input validation helpers, as the JAX package's ``runtime/validation.py``.

Error message wording matches it so scripted callers keep working.
"""
from __future__ import annotations

from pathlib import Path

from style_transfer_visualizer_tpu_torch.constants import (
    VIDEO_QUALITY_MAX,
    VIDEO_QUALITY_MIN,
)


def _require_file(path: str, what: str) -> None:
    if Path(path).is_file():
        return
    msg = f"{what} image not found: {path}"
    raise FileNotFoundError(msg)


def validate_input_paths(content_path: str, style_path: str) -> None:
    """Ensure both input paths point at existing files."""
    _require_file(content_path, "Content")
    _require_file(style_path, "Style")


def validate_parameters(video_quality: int) -> None:
    """Range-check runtime parameters not covered by the config schema."""
    if VIDEO_QUALITY_MIN <= video_quality <= VIDEO_QUALITY_MAX:
        return
    msg = (
        f"Video quality must be between {VIDEO_QUALITY_MIN} and "
        f"{VIDEO_QUALITY_MAX}, got {video_quality}"
    )
    raise ValueError(msg)
