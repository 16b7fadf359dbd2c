"""Host-side video decoding: clip files in, uint8 RGB frames out.

The port of the JAX package's ``media/decode.py``, for the
``style-sequence-torch`` pipeline: animated images (GIF/WebP/APNG)
decode through Pillow's multi-frame API with no external binary, and
container formats (MP4/MOV/MKV/WebM/AVI/M4V) decode through an ffmpeg
process, a rawvideo RGB24 pipe read frame by frame so a long clip is
never held in memory whole. The probe of a container parses ffmpeg's
stream description (``ffmpeg -i``), as the JAX package does.

Everything here is host-side I/O; frames reach the device through the
sequence's own loader. Pillow is imported inside the functions that use
it.
"""
from __future__ import annotations

import re
import subprocess
import tempfile
from pathlib import Path
from typing import TYPE_CHECKING, NamedTuple

import numpy as np

from style_transfer_visualizer_tpu_torch.media.encode import ffmpeg_available
from style_transfer_visualizer_tpu_torch.utils.logging import logger

if TYPE_CHECKING:
    from collections.abc import Iterator

# Formats Pillow decodes natively as multi-frame images.
PIL_ANIMATED_SUFFIXES = (".gif", ".webp", ".apng")
# Container formats that need the ffmpeg process.
FFMPEG_VIDEO_SUFFIXES = (".mp4", ".mov", ".mkv", ".webm", ".avi", ".m4v")
VIDEO_SUFFIXES = PIL_ANIMATED_SUFFIXES + FFMPEG_VIDEO_SUFFIXES

_DEFAULT_FPS = 10
# "..., 1920x1080 [SAR ...]" / "..., 640x360," in ffmpeg stream lines.
_FFMPEG_DIMS_RE = re.compile(r"\b(\d{2,5})x(\d{2,5})\b")
# "..., 29.97 fps," in ffmpeg stream lines.
_FFMPEG_FPS_RE = re.compile(r"\b([\d.]+)\s*fps\b")


class VideoInfo(NamedTuple):
    """Probed stream geometry of a clip.

    ``n_frames`` is None when the container does not declare it (the
    ffmpeg pipe finds the end of the clip only at EOF). ``fps`` falls
    back to 10 (the pipeline's default frame rate) when the stream
    carries no usable rate.
    """

    width: int
    height: int
    fps: float
    n_frames: int | None


def is_video_file(path: str | Path) -> bool:
    """Whether ``path`` names an existing decodable clip file."""
    p = Path(path)
    return p.is_file() and p.suffix.lower() in VIDEO_SUFFIXES


def probe_video(path: str | Path) -> VideoInfo:
    """Read a clip's dimensions, frame rate, and (if known) length."""
    path = Path(path)
    if not path.is_file():
        msg = f"Video file not found: {path}"
        raise FileNotFoundError(msg)
    if path.suffix.lower() in PIL_ANIMATED_SUFFIXES:
        return _probe_pil(path)
    return _probe_ffmpeg(path)


def iter_video_frames(path: str | Path) -> Iterator[np.ndarray]:
    """Yield a clip's frames as uint8 (H, W, 3) RGB arrays, in order."""
    path = Path(path)
    if path.suffix.lower() in PIL_ANIMATED_SUFFIXES:
        yield from _iter_pil_frames(path)
    else:
        yield from _iter_ffmpeg_frames(path, probe_video(path))


def extract_frames(
    path: str | Path,
    dest_dir: str | Path,
    *,
    max_frames: int | None = None,
    stride: int = 1,
) -> list[Path]:
    """Decode a clip into ``frame_{i:05d}.png`` files under ``dest_dir``.

    ``stride`` keeps every stride-th source frame; ``max_frames`` caps
    the count after striding. Returns the written paths in temporal
    order; the names sort naturally, so ``sequence.discover_frames``
    gives the same order back.
    """
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    if stride < 1:
        msg = f"stride must be >= 1, got {stride}"
        raise ValueError(msg)
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    for i, frame in enumerate(iter_video_frames(path)):
        if i % stride:
            continue
        out = dest_dir / f"frame_{len(written):05d}.png"
        Image.fromarray(frame).save(out)
        written.append(out)
        if max_frames is not None and len(written) >= max_frames:
            break
    if not written:
        msg = f"No frames decoded from {path}"
        raise ValueError(msg)
    logger.info("Extracted %d frames from %s", len(written), path)
    return written


def _probe_pil(path: Path) -> VideoInfo:
    from PIL import Image  # noqa: PLC0415 - optional, file I/O only

    with Image.open(path) as img:
        # GIF frame duration is in milliseconds; 0 or absent means the
        # encoder left it unspecified.
        duration_ms = img.info.get("duration") or 0
        fps = 1000.0 / duration_ms if duration_ms else float(_DEFAULT_FPS)
        return VideoInfo(
            width=img.width,
            height=img.height,
            fps=fps,
            n_frames=getattr(img, "n_frames", 1),
        )


def _iter_pil_frames(path: Path) -> Iterator[np.ndarray]:
    from PIL import Image, ImageSequence  # noqa: PLC0415 - file I/O only

    with Image.open(path) as img:
        for frame in ImageSequence.Iterator(img):
            yield np.asarray(frame.convert("RGB"), dtype=np.uint8)


def _require_ffmpeg(path: Path) -> None:
    if not ffmpeg_available():
        msg = (
            f"Decoding {path.suffix} input requires an ffmpeg binary on "
            "PATH (GIF/WebP/APNG inputs decode without it)."
        )
        raise RuntimeError(msg)


def _probe_ffmpeg(path: Path) -> VideoInfo:
    _require_ffmpeg(path)
    # `ffmpeg -i <file>` with no output exits non-zero by design but
    # prints the stream description: that is the probe (no ffprobe
    # needed; minimal builds often ship only ffmpeg).
    proc = subprocess.run(  # noqa: S603 - fixed argv, no shell
        ["ffmpeg", "-hide_banner", "-i", str(path)],  # noqa: S607
        capture_output=True,
        text=True,
        check=False,
    )
    stream_lines = [
        line for line in proc.stderr.splitlines() if "Video:" in line
    ]
    if not stream_lines:
        msg = f"ffmpeg found no video stream in {path}"
        raise ValueError(msg)
    line = stream_lines[0]
    dims = _FFMPEG_DIMS_RE.search(line)
    if dims is None:
        msg = f"Could not parse video dimensions from ffmpeg: {line!r}"
        raise ValueError(msg)
    fps_match = _FFMPEG_FPS_RE.search(line)
    fps = float(fps_match.group(1)) if fps_match else float(_DEFAULT_FPS)
    return VideoInfo(
        width=int(dims.group(1)),
        height=int(dims.group(2)),
        fps=fps or float(_DEFAULT_FPS),
        n_frames=None,
    )


def _iter_ffmpeg_frames(path: Path, info: VideoInfo) -> Iterator[np.ndarray]:
    _require_ffmpeg(path)
    frame_bytes = info.width * info.height * 3
    cmd = [
        "ffmpeg",
        "-v", "error",
        "-i", str(path),
        "-f", "rawvideo",
        "-pix_fmt", "rgb24",
        "-",
    ]
    # stderr goes to a file, as in the encoder (media/encode.py): an
    # error stream larger than the pipe buffer must never block the
    # stdout drain.
    with tempfile.TemporaryFile() as stderr_file:
        proc = subprocess.Popen(  # noqa: S603 - fixed argv, no shell
            cmd,
            stdout=subprocess.PIPE,
            stderr=stderr_file,
        )
        try:
            while True:
                chunk = proc.stdout.read(frame_bytes)
                if not chunk:
                    break
                if len(chunk) != frame_bytes:
                    msg = (
                        f"Truncated frame from ffmpeg while decoding "
                        f"{path}: got {len(chunk)} of {frame_bytes} bytes"
                    )
                    raise ValueError(msg)
                yield (
                    np.frombuffer(chunk, dtype=np.uint8)
                    .reshape(info.height, info.width, 3)
                    .copy()
                )
        finally:
            proc.stdout.close()
            returncode = proc.wait()
        if returncode:
            stderr_file.seek(0)
            tail = stderr_file.read()[-2000:].decode(errors="replace")
            msg = f"ffmpeg decode of {path} failed ({returncode}): {tail}"
            raise RuntimeError(msg)
