"""Host-side encoders: MP4 via an ffmpeg pipe, GIF via imageio/Pillow.

The port's own copy of the JAX package's ``media/encode.py``: a lazily
spawned ffmpeg subprocess consuming raw RGB24 frames on stdin (libx264,
fps, the quality-to-CRF mapping, macroblock-16 size alignment, the
title/artist/comment/encoder/creation_time tags), the same command line
and bytes. ``FfmpegPipeWriter`` streams frames as they arrive;
``PostprocessVideoWriter`` spills PNG frames beside the output and
encodes once on close; ``GifFrameCollector`` spills likewise and encodes
a looping GIF (which needs no ffmpeg at all). Without ffmpeg on PATH
the MP4 writers raise ``RuntimeError``. Pillow and imageio are imported
inside the functions that use them.
"""
from __future__ import annotations

import shutil
import subprocess
import tempfile
from datetime import UTC, datetime
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from style_transfer_visualizer_tpu_torch.constants import (
    ENCODING_BLOCK_SIZE,
    VIDEO_CODEC,
)
from style_transfer_visualizer_tpu_torch.media.sinks import ensure_rgb_uint8
from style_transfer_visualizer_tpu_torch.utils.logging import logger
from style_transfer_visualizer_tpu_torch.utils.version import (
    resolve_project_version,
)

if TYPE_CHECKING:
    from style_transfer_visualizer_tpu_torch.config import VideoConfig
    from style_transfer_visualizer_tpu_torch.media.sinks import VideoFrameSink

_PNG_SUFFIX = ".png"


def ffmpeg_available() -> bool:
    """Whether an ffmpeg binary is on PATH."""
    return shutil.which("ffmpeg") is not None


def _utc_timestamp() -> str:
    return datetime.now(UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


def build_mp4_metadata_args(
    title: str | None,
    artist: str | None,
) -> list[str]:
    """Container-level metadata tags recognized across platforms."""
    version = resolve_project_version()
    tags = {
        "title": title or "Style Transfer Visualizer Output",
        "artist": artist or "Style Transfer Visualizer",
        "comment": f"Created using style_transfer_visualizer v{version}",
        "encoder": f"style_transfer_visualizer v{version}",
        "creation_time": _utc_timestamp(),
    }
    args: list[str] = []
    for key, value in tags.items():
        args.extend(["-metadata", f"{key}={value}"])
    return args


def quality_to_crf(quality: int) -> int:
    """Map the 1-10 quality scale onto x264 CRF (10 = best).

    Truncates like imageio-ffmpeg's mapping so the same configured
    quality yields the same CRF as imageio's writer.
    """
    return int((1.0 - quality / 10.0) * 51.0)


def _block_align(value: int, block: int = ENCODING_BLOCK_SIZE) -> int:
    """Round up to the codec macroblock size."""
    return ((value + block - 1) // block) * block


class FfmpegPipeWriter:
    """Realtime MP4 sink streaming raw frames into an ffmpeg subprocess.

    The process is spawned on the first frame (when dimensions are
    known). Frames whose dimensions are not macroblock-aligned are
    scaled up by ffmpeg to the next multiple of 16, as imageio does.
    """

    def __init__(self, config: VideoConfig, output_path: Path) -> None:
        if not ffmpeg_available():
            msg = (
                "ffmpeg binary not found on PATH; MP4 output requires "
                "ffmpeg. Use --no-video or GIF output instead."
            )
            raise RuntimeError(msg)
        self._config = config
        self._output_path = output_path
        self._proc: subprocess.Popen[bytes] | None = None
        self._stderr_file = None
        self._closed = False
        self._size: tuple[int, int] | None = None
        self._input_size: tuple[int, int] | None = None

    def _spawn(self, width: int, height: int) -> None:
        self._output_path.parent.mkdir(parents=True, exist_ok=True)
        out_w = _block_align(width)
        out_h = _block_align(height)
        self._input_size = (width, height)
        # Contract: _size is the ACCEPTED INPUT frame size — outro
        # rendering sizes its frames to writer._size and appends them
        # (segments.resolve_writer_dimensions). Macroblock alignment is
        # an internal encoder concern handled by the scale filter.
        self._size = (width, height)

        cmd = [
            "ffmpeg", "-y",
            "-loglevel", "error",
            "-f", "rawvideo",
            "-pix_fmt", "rgb24",
            "-s", f"{width}x{height}",
            "-r", str(self._config.fps),
            "-i", "-",
            "-an",
            "-vcodec", VIDEO_CODEC,
            "-pix_fmt", "yuv420p",
            "-crf", str(quality_to_crf(self._config.quality)),
        ]
        if (out_w, out_h) != (width, height):
            cmd.extend(["-vf", f"scale={out_w}:{out_h}"])
        cmd.extend(
            build_mp4_metadata_args(
                self._config.metadata_title, self._config.metadata_artist,
            ),
        )
        cmd.append(str(self._output_path))
        # stderr goes to a spill file, not a pipe: a chatty or failing
        # encoder writing more than the OS pipe buffer would otherwise
        # block, stop draining stdin, and deadlock append_data.
        self._stderr_file = tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stderr=self._stderr_file,
        )

    def append_data(self, frame: np.ndarray) -> None:
        """Stream one frame into the encoder."""
        if self._closed:
            msg = "Cannot append frame after writer has been closed."
            raise RuntimeError(msg)
        rgb = ensure_rgb_uint8(frame)
        if self._proc is None:
            self._spawn(rgb.shape[1], rgb.shape[0])
        elif (rgb.shape[1], rgb.shape[0]) != self._input_size:
            msg = (
                f"Frame size {rgb.shape[1]}x{rgb.shape[0]} does not match "
                f"writer size {self._input_size}"
            )
            raise ValueError(msg)
        assert self._proc is not None and self._proc.stdin is not None
        self._proc.stdin.write(rgb.tobytes())

    def close(self) -> None:
        """Flush the pipe and wait for the encoder to finish."""
        if self._closed:
            return
        self._closed = True
        if self._proc is None:
            return
        assert self._proc.stdin is not None
        self._proc.stdin.close()
        self._proc.wait()
        returncode = self._proc.returncode
        stderr = b""
        # One-way: _spawn always opens the spill file alongside _proc.
        if self._stderr_file is not None:  # pragma: no branch
            self._stderr_file.seek(0)
            stderr = self._stderr_file.read()
            self._stderr_file.close()
            self._stderr_file = None
        if returncode != 0:
            detail = stderr.decode(errors="replace")[-2000:]
            logger.error("ffmpeg exited with %d: %s", returncode, detail)
            # Match imageio's ffmpeg writer, which raises on a
            # failed encode — callers and scripts must see the failure.
            msg = f"ffmpeg exited with {returncode}: {detail[-300:]}"
            raise OSError(msg)


class PostprocessVideoWriter:
    """Spill frames to disk during optimization; encode once on close."""

    def __init__(self, config: VideoConfig, output_path: Path) -> None:
        if not ffmpeg_available():
            # Fail fast: discovering this in close() — after hours of
            # optimization — would destroy the spilled frames for nothing.
            msg = (
                "ffmpeg binary not found on PATH; MP4 output requires "
                "ffmpeg. Use --no-video or GIF output instead."
            )
            raise RuntimeError(msg)
        self._config = config
        self._output_path = output_path
        output_path.parent.mkdir(parents=True, exist_ok=True)
        self._temp_dir = Path(
            tempfile.mkdtemp(prefix="stv_frames_", dir=output_path.parent),
        )
        self._frames: list[Path] = []
        self._closed = False
        self._size: tuple[int, int] | None = None

    def append_data(self, frame: np.ndarray) -> None:
        """Persist one frame as a PNG in the spill directory."""
        if self._closed:
            msg = "Cannot append frame after writer has been closed."
            raise RuntimeError(msg)
        from PIL import Image  # noqa: PLC0415 - optional dependency

        rgb = ensure_rgb_uint8(frame)
        self._size = (rgb.shape[1], rgb.shape[0])
        frame_path = self._temp_dir / (
            f"frame_{len(self._frames):08d}{_PNG_SUFFIX}"
        )
        Image.fromarray(rgb, mode="RGB").save(frame_path, format="PNG")
        self._frames.append(frame_path)

    def close(self) -> None:
        """Encode all spilled frames, then remove the spill directory."""
        if self._closed:
            return
        self._closed = True
        try:
            if not self._frames:
                return
            from PIL import Image  # noqa: PLC0415 - optional dependency

            writer = FfmpegPipeWriter(self._config, self._output_path)
            try:
                for frame_path in self._frames:
                    with Image.open(frame_path) as img:
                        writer.append_data(
                            np.asarray(img.convert("RGB"), dtype=np.uint8),
                        )
            finally:
                writer.close()
        finally:
            shutil.rmtree(self._temp_dir, ignore_errors=True)


class GifFrameCollector:
    """Spill frames destined for GIF export; encode a looping GIF on close."""

    def __init__(self, output_path: Path, fps: int) -> None:
        self._output_path = output_path
        self._fps = max(1, fps)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        self._temp_dir = Path(
            tempfile.mkdtemp(prefix="stv_gif_", dir=output_path.parent),
        )
        self._frames: list[Path] = []
        self._closed = False
        self._size: tuple[int, int] | None = None

    def append_data(self, frame: np.ndarray) -> None:
        """Persist one frame for the GIF."""
        if self._closed:
            msg = "Cannot append frame after GIF collector has been closed."
            raise RuntimeError(msg)
        from PIL import Image  # noqa: PLC0415 - optional dependency

        rgb = ensure_rgb_uint8(frame)
        self._size = (rgb.shape[1], rgb.shape[0])
        frame_path = self._temp_dir / (
            f"gif_{len(self._frames):08d}{_PNG_SUFFIX}"
        )
        Image.fromarray(rgb, mode="RGB").save(frame_path, format="PNG")
        self._frames.append(frame_path)

    def close(self) -> None:
        """Encode the GIF (infinite loop, 1/fps frame duration)."""
        if self._closed:
            return
        self._closed = True
        try:
            if not self._frames:
                return
            import imageio.v2 as imageio  # noqa: PLC0415
            from PIL import Image  # noqa: PLC0415 - optional dependency

            self._output_path.parent.mkdir(parents=True, exist_ok=True)
            # Modern imageio's Pillow plugin takes GIF frame duration
            # in MILLISECONDS (matching PIL); passing seconds here
            # silently writes 0 ms frames (viewers then substitute
            # their own ~100 ms default, masking the wrong rate).
            with imageio.get_writer(
                self._output_path.as_posix(),
                mode="I",
                duration=1000.0 / float(self._fps),
                loop=0,
            ) as writer:
                for frame_path in self._frames:
                    with Image.open(frame_path) as img:
                        writer.append_data(
                            np.asarray(img.convert("RGB"), dtype=np.uint8),
                        )
        finally:
            shutil.rmtree(self._temp_dir, ignore_errors=True)


def setup_video_writer(
    config: VideoConfig,
    output_dir: Path,
    video_name: str,
) -> VideoFrameSink | None:
    """Build the configured MP4 sink, or None when video is disabled."""
    if not config.create_video:
        return None
    output_path = (output_dir / video_name).resolve()
    if config.mode == "postprocess":
        return PostprocessVideoWriter(config, output_path)
    if config.mode != "realtime":
        msg = f"Unsupported video mode: {config.mode}"
        raise ValueError(msg)
    return FfmpegPipeWriter(config, output_path)


def setup_gif_collector(
    config: VideoConfig,
    output_dir: Path,
    gif_name: str,
) -> VideoFrameSink | None:
    """Build the GIF sink, or None when GIF export is disabled."""
    if not config.create_gif:
        return None
    return GifFrameCollector((output_dir / gif_name).resolve(), config.fps)
