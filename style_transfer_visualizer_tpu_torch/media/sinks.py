"""Frame sinks: the boundary between device frames and host encoders.

The port's own copy of the JAX package's ``media/sinks.py``.
``VideoFrameSink`` is the minimal writer protocol shared by the MP4
pipe writer, the postprocess spill writer, the GIF collector, and test
doubles. Frame validation is centralized in ``ensure_rgb_uint8``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

_FRAME_NDIMS = 3
_RGB_CHANNELS = 3
MAX_RGB_VALUE = 255


@runtime_checkable
class VideoFrameSink(Protocol):
    """Writer-like object accepting RGB uint8 frames."""

    _size: tuple[int, int] | None

    def append_data(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) RGB frame."""

    def close(self) -> None:
        """Flush and release resources."""


def ensure_rgb_uint8(
    frame: np.ndarray,
    *,
    message: str | None = None,
) -> np.ndarray:
    """Validate shape and coerce dtype of an RGB frame."""
    if frame.ndim != _FRAME_NDIMS or frame.shape[-1] != _RGB_CHANNELS:
        msg = message or "Frames must be RGB arrays with shape (H, W, 3)"
        raise ValueError(msg)
    if frame.dtype != np.uint8:
        frame = np.clip(np.rint(frame), 0, MAX_RGB_VALUE).astype(np.uint8)
    return np.asarray(frame, dtype=np.uint8)
