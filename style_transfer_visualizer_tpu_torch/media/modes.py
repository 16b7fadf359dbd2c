"""Automatic realtime->postprocess video-mode promotion heuristic.

The port's own copy of the JAX package's ``media/modes.py``: the same
thresholds and reason strings, so the same run promotes the same way.
Very long runs, 4K-class frames, high-res frames, high fps, or dense
frame sampling all push encoding after optimization. An explicit
user-selected mode always wins.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import VideoConfig
    from style_transfer_visualizer_tpu_torch.type_defs import VideoMode

_MEGAPIXEL = 1_000_000
LONG_RUN_FRAME_THRESHOLD = 2400
HIGH_RES_AREA = 2560 * 1440
HIGH_RES_FRAME_THRESHOLD = 2000
ULTRA_RES_AREA = 3840 * 2160
ULTRA_RES_FRAME_THRESHOLD = 280
HIGH_FPS_THRESHOLD = 48
HIGH_FPS_FRAME_THRESHOLD = 2000
SAVE_EVERY_THRESHOLD = 5
SAVE_EVERY_FRAME_THRESHOLD = 2000


def _auto_postprocess_reason(
    config: VideoConfig,
    *,
    frame_size: tuple[int, int],
    total_steps: int,
) -> tuple[str | None, int]:
    """Return (reason, estimated_frames); reason None when realtime is ok."""
    if config.save_every <= 0:
        return None, 0

    estimated_frames = total_steps // config.save_every
    if estimated_frames <= 0:
        return None, estimated_frames

    width, height = frame_size
    if width <= 0 or height <= 0:
        return None, estimated_frames

    area = width * height
    reason: str | None = None

    if estimated_frames >= LONG_RUN_FRAME_THRESHOLD:
        reason = (
            f"estimated {estimated_frames} frames exceeds long-run "
            f"threshold ({LONG_RUN_FRAME_THRESHOLD})"
        )
    elif (
        area >= ULTRA_RES_AREA
        and estimated_frames >= ULTRA_RES_FRAME_THRESHOLD
    ):
        reason = (
            f"4K-class frame ({width}x{height}) with "
            f"{estimated_frames} frames"
        )
    elif (
        area >= HIGH_RES_AREA
        and estimated_frames >= HIGH_RES_FRAME_THRESHOLD
    ):
        reason = (
            f"high-res {area / _MEGAPIXEL:.1f}MP frame with "
            f"{estimated_frames} frames"
        )
    elif (
        config.fps >= HIGH_FPS_THRESHOLD
        and estimated_frames >= HIGH_FPS_FRAME_THRESHOLD
    ):
        reason = (
            f"{config.fps} fps run producing {estimated_frames} frames "
            "while encoding in realtime"
        )
    elif (
        config.save_every <= SAVE_EVERY_THRESHOLD
        and estimated_frames >= SAVE_EVERY_FRAME_THRESHOLD
    ):
        reason = (
            f"--save-every {config.save_every} yields "
            f"{estimated_frames} frames"
        )

    return reason, estimated_frames


def select_video_mode(
    config: VideoConfig,
    *,
    frame_size: tuple[int, int],
    total_steps: int,
) -> tuple[VideoMode, str | None, int]:
    """Pick the effective mode; reason is set only on auto-promotion."""
    reason, estimated_frames = _auto_postprocess_reason(
        config, frame_size=frame_size, total_steps=total_steps,
    )

    if config.mode_override or config.mode == "postprocess":
        return config.mode, None, estimated_frames
    if reason is not None:
        return "postprocess", reason, estimated_frames
    return config.mode, None, estimated_frames
