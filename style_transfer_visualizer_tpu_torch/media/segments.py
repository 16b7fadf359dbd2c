"""Intro/outro segments, fades, and crossfades for timelapse videos.

The port's own copy of the JAX package's ``media/segments.py``: the same
transition budgets (fade seconds, crossfade caps), gallery-rendered
intro and outro frames and hold durations. ``blend_frames`` computes
the 16.16 fixed-point blend of the JAX package's native frame library
(``native/frameops.c``, ``blend_u8``) in numpy ``uint32``, so the two
packages blend bit-equally with no native build. Pillow is imported
inside the functions that render.
"""
from __future__ import annotations

from contextlib import ExitStack
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from style_transfer_visualizer_tpu_torch.constants import COLOR_GREY
from style_transfer_visualizer_tpu_torch.image_grid.core import FrameParams
from style_transfer_visualizer_tpu_torch.image_grid.layouts import (
    make_gallery_comparison,
)
from style_transfer_visualizer_tpu_torch.media.sinks import ensure_rgb_uint8

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import VideoConfig
    from style_transfer_visualizer_tpu_torch.media.sinks import VideoFrameSink

INTRO_FADE_IN_SECONDS = 1.0
INTRO_CROSSFADE_SECONDS = 0.5
INTRO_MAX_FADE_FRAMES = 48
INTRO_MAX_CROSSFADE_FRAMES = 12
INTRO_MIN_DIM = 128
OUTRO_CROSSFADE_SECONDS = 0.5
OUTRO_MAX_CROSSFADE_FRAMES = 12
OUTRO_MIN_DIM = 512
FINAL_COMPARISON_MIN_FRAMES = 1
FINAL_TIMELAPSE_HOLD_SECONDS = 1.0
FINAL_TIMELAPSE_MIN_FRAMES = 1


_FIXED_ONE = 65536  # 1.0 in 16.16 fixed point


def blend_frames(
    frame_a: np.ndarray,
    frame_b: np.ndarray,
    alpha: float,
) -> np.ndarray:
    """Linear blend of two equally-shaped uint8 RGB frames.

    ``round(a*(1-alpha) + b*alpha)`` in 16.16 fixed point: ``alpha`` is
    clamped into [0, 1] in float32 (NaN to 0), ``wb = alpha * 65536 +
    0.5`` is computed in float32 and truncated, ``wa = 65536 - wb``, and
    each byte is ``(a*wa + b*wb + 32768) >> 16``.
    """
    if frame_a.shape != frame_b.shape:
        msg = "Frames must share shape for blending"
        raise ValueError(msg)
    a = np.ascontiguousarray(frame_a, dtype=np.uint8)
    b = np.ascontiguousarray(frame_b, dtype=np.uint8)
    alpha32 = np.float32(alpha)
    if not alpha32 > 0:
        alpha32 = np.float32(0.0)
    alpha32 = min(alpha32, np.float32(1.0))
    wb = min(
        int(alpha32 * np.float32(_FIXED_ONE) + np.float32(0.5)), _FIXED_ONE,
    )
    mixed = (
        a.astype(np.uint32) * np.uint32(_FIXED_ONE - wb)
        + b.astype(np.uint32) * np.uint32(wb)
        + np.uint32(_FIXED_ONE // 2)
    )
    return (mixed >> np.uint32(16)).astype(np.uint8)


def append_fade_transition(
    writer: VideoFrameSink,
    start_frame: np.ndarray,
    end_frame: np.ndarray,
    frame_count: int,
) -> None:
    """Emit a linear fade from start to end over ``frame_count`` frames."""
    if frame_count <= 0:
        writer.append_data(end_frame)
        return
    for idx in range(frame_count):
        alpha = (idx + 1) / frame_count
        writer.append_data(blend_frames(start_frame, end_frame, alpha))


def append_crossfade(
    writer: VideoFrameSink,
    start_frame: np.ndarray,
    end_frame: np.ndarray,
    frame_count: int,
    *,
    max_frames: int = INTRO_MAX_CROSSFADE_FRAMES,
) -> None:
    """Emit a bounded crossfade strictly between the two endpoint frames.

    Alphas run (1..n)/(n+1) so neither endpoint frame is duplicated.
    """
    if frame_count <= 0:
        return
    limited = max(1, min(frame_count, max_frames))
    for idx in range(limited):
        alpha = (idx + 1) / (limited + 1)
        writer.append_data(blend_frames(start_frame, end_frame, alpha))


@dataclass(slots=True)
class GifSegmentOptions:
    """Optional GIF participation in intro/outro segments."""

    sink: VideoFrameSink | None = None
    include_intro: bool = False
    include_outro: bool = False


def build_intro_frame(content_path: Path, style_path: Path) -> np.ndarray:
    """Render the two-across gallery intro frame at the content size.

    Inputs smaller than ``INTRO_MIN_DIM`` are upscaled for rendering and
    the gallery is LANCZOS-resized back to the content dimensions.
    """
    from PIL import Image  # noqa: PLC0415 - optional dependency

    with ExitStack() as stack:
        content = stack.enter_context(Image.open(content_path))
        style = stack.enter_context(Image.open(style_path))
        base_w, base_h = content.size
        if base_w <= 0 or base_h <= 0:
            msg = "Content image has invalid dimensions"
            raise ValueError(msg)
        scale = max(
            INTRO_MIN_DIM / base_w if base_w < INTRO_MIN_DIM else 1.0,
            INTRO_MIN_DIM / base_h if base_h < INTRO_MIN_DIM else 1.0,
            1.0,
        )
        render_size = (
            max(1, round(base_w * scale)),
            max(1, round(base_h * scale)),
        )
        gallery = make_gallery_comparison(
            content=content,
            style=style,
            result=None,
            target_size=render_size,
            layout="gallery-two-across",
            wall_color=COLOR_GREY,
            frame=FrameParams(frame_tone="gold", label="on"),
        )
        if gallery.size != content.size:
            gallery = gallery.resize(
                content.size, Image.Resampling.LANCZOS,
            )
    return np.asarray(gallery.convert("RGB"), dtype=np.uint8)


def prepare_intro_segment(
    config: VideoConfig,
    writer: VideoFrameSink | None,
    paths: tuple[Path, Path],
    gif_options: GifSegmentOptions | None = None,
) -> tuple[np.ndarray, int] | None:
    """Emit the intro fade-in and hold; return (last frame, crossfade len).

    The crossfade into the first stylized frame is deferred to the
    optimization loop. Returns None when no sink wants the intro.
    """
    content_path, style_path = paths
    gif_sink = gif_options.sink if gif_options else None
    include_gif_intro = bool(gif_options and gif_options.include_intro)

    use_writer = (
        writer is not None and config.create_video and config.intro_enabled
    )
    use_gif = (
        gif_sink is not None and include_gif_intro and config.intro_enabled
    )
    if not use_writer and not use_gif:
        return None

    intro_frame = build_intro_frame(content_path, style_path)
    fade_frames = max(
        1,
        min(
            round(config.fps * INTRO_FADE_IN_SECONDS),
            INTRO_MAX_FADE_FRAMES,
        ),
    )
    hold_frames = max(0, round(config.fps * config.intro_duration_seconds))

    black = np.zeros_like(intro_frame)
    live_sinks = [
        sink
        for sink, used in ((writer, use_writer), (gif_sink, use_gif))
        if used and sink is not None
    ]
    for sink in live_sinks:
        append_fade_transition(sink, black, intro_frame, fade_frames)
    for _ in range(hold_frames):
        for sink in live_sinks:
            sink.append_data(intro_frame)

    crossfade_frames = max(
        1,
        min(
            round(config.fps * INTRO_CROSSFADE_SECONDS),
            INTRO_MAX_CROSSFADE_FRAMES,
        ),
    )
    return intro_frame, crossfade_frames


def resolve_writer_dimensions(
    writer: VideoFrameSink,
    last_frame: np.ndarray,
) -> tuple[np.ndarray, int, int]:
    """Align the last timelapse frame with the writer's output size."""
    last_rgb = ensure_rgb_uint8(
        last_frame,
        message="Last timelapse frame must be an RGB array",
    )
    target_w = last_rgb.shape[1]
    target_h = last_rgb.shape[0]

    writer_size = getattr(writer, "_size", None)
    if isinstance(writer_size, tuple) and len(writer_size) == 2:
        w, h = writer_size
        if w > 0 and h > 0:
            target_w, target_h = int(w), int(h)

    if (target_h, target_w) != last_rgb.shape[:2]:
        from PIL import Image  # noqa: PLC0415 - optional dependency

        resized = Image.fromarray(last_rgb).resize(
            (target_w, target_h), Image.Resampling.LANCZOS,
        )
        last_rgb = np.asarray(resized, dtype=np.uint8)
    return last_rgb, target_w, target_h


def build_outro_frame(
    content_style_paths: tuple[Path, Path],
    result_image: object,
    frame_params: FrameParams,
    *,
    target_width: int,
    target_height: int,
) -> np.ndarray:
    """Render the stacked-left outro comparison at writer dimensions.

    Rendering happens at >= OUTRO_MIN_DIM for quality, then LANCZOS
    resizes down to the writer size.
    """
    from PIL import Image  # noqa: PLC0415 - optional dependency

    render_size = (
        max(target_width, OUTRO_MIN_DIM),
        max(target_height, OUTRO_MIN_DIM),
    )
    with ExitStack() as stack:
        content_path, style_path = content_style_paths
        content = stack.enter_context(Image.open(content_path))
        style = stack.enter_context(Image.open(style_path))
        comparison = make_gallery_comparison(
            content=content,
            style=style,
            result=result_image,
            target_size=render_size,
            layout="gallery-stacked-left",
            wall_color=COLOR_GREY,
            frame=frame_params,
        )
    comparison = comparison.convert("RGB")
    if comparison.size != (target_width, target_height):
        comparison = comparison.resize(
            (target_width, target_height), Image.Resampling.LANCZOS,
        )
    return np.asarray(comparison, dtype=np.uint8)


def append_final_comparison_frame(
    config: VideoConfig,
    writer: VideoFrameSink | None,
    paths: tuple[Path, Path],
    last_frame: np.ndarray,
    gif_options: GifSegmentOptions | None = None,
) -> None:
    """Emit the outro: hold the last frame, crossfade to the comparison.

    Sequence per sink: ~1s hold of the final stylized frame, a bounded
    crossfade into the stacked-left gallery comparison, then an
    ``outro_duration_seconds`` hold. No-op when disabled.
    """
    gif_sink = gif_options.sink if gif_options else None
    include_gif_outro = bool(gif_options and gif_options.include_outro)

    use_writer = (
        writer is not None
        and config.create_video
        and config.final_frame_compare
    )
    use_gif = (
        gif_sink is not None
        and include_gif_outro
        and config.final_frame_compare
    )
    if not use_writer and not use_gif:
        return

    from PIL import Image  # noqa: PLC0415 - optional dependency

    validated_last = ensure_rgb_uint8(
        last_frame,
        message="Last timelapse frame must be an RGB array",
    )
    result_image = Image.fromarray(validated_last)
    frame_params = FrameParams(frame_tone="gold", label="on")

    targets: list[tuple[VideoFrameSink, np.ndarray, np.ndarray]] = []
    outro_cache: dict[tuple[int, int], np.ndarray] = {}
    for sink, used in ((writer, use_writer), (gif_sink, use_gif)):
        if sink is None or not used:
            continue
        last_rgb, target_w, target_h = resolve_writer_dimensions(
            sink, validated_last,
        )
        # Video and GIF sinks usually share dimensions; the gallery
        # render is multi-second host work, so build it once per size.
        key = (target_w, target_h)
        if key not in outro_cache:
            outro_cache[key] = build_outro_frame(
                paths,
                result_image,
                frame_params,
                target_width=target_w,
                target_height=target_h,
            )
        targets.append((sink, last_rgb, outro_cache[key]))

    hold_frames = max(
        FINAL_TIMELAPSE_MIN_FRAMES,
        round(config.fps * FINAL_TIMELAPSE_HOLD_SECONDS),
    )
    for _ in range(hold_frames):
        for sink, last_rgb, _ in targets:
            sink.append_data(last_rgb)

    crossfade_frames = max(
        1,
        min(
            round(config.fps * OUTRO_CROSSFADE_SECONDS),
            OUTRO_MAX_CROSSFADE_FRAMES,
        ),
    )
    for sink, last_rgb, outro_np in targets:
        append_crossfade(
            sink, last_rgb, outro_np, crossfade_frames,
            max_frames=OUTRO_MAX_CROSSFADE_FRAMES,
        )

    outro_hold = max(
        FINAL_COMPARISON_MIN_FRAMES,
        round(config.fps * max(0.0, config.outro_duration_seconds)),
    )
    for _ in range(outro_hold):
        for sink, _, outro_np in targets:
            sink.append_data(outro_np)
