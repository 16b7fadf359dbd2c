"""Best-effort project version resolution (feeds MP4 metadata tags).

The same order as the JAX package's ``utils/version.py``: installed
distribution metadata, then a ``pyproject.toml`` walk-up, then a
development fallback. Both packages ship in one distribution, so both
stamp the same version into their MP4s.
"""
from __future__ import annotations

import tomllib
from importlib import metadata as importlib_metadata
from pathlib import Path

from style_transfer_visualizer_tpu_torch.utils.logging import logger

_DIST_NAMES = (
    "style-transfer-visualizer-tpu",
    "style_transfer_visualizer_tpu",
)
_FALLBACK = "0.0.0"


def resolve_project_version() -> str:
    """Return the installed or source-tree version, else "0.0.0"."""
    for dist in _DIST_NAMES:
        try:
            return importlib_metadata.version(dist)
        except importlib_metadata.PackageNotFoundError:
            continue

    for parent in Path(__file__).resolve().parents:
        pyproject = parent / "pyproject.toml"
        if not pyproject.is_file():
            continue
        try:
            with pyproject.open("rb") as fh:
                data = tomllib.load(fh)
        except (OSError, tomllib.TOMLDecodeError) as exc:
            logger.warning("Error reading %s: %s", pyproject, exc)
            break
        version = data.get("project", {}).get("version")
        if isinstance(version, str) and version.strip():
            return version.strip()

    return _FALLBACK
