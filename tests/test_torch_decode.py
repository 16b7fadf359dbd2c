"""The port's ``media/decode.py`` vs the JAX package's, on the CPU.

- GIF, APNG and animated WebP decode through Pillow: the port's frames,
  probe and extracted PNGs equal the JAX package's, frame for frame;
- the ffmpeg path runs against a stand-in ``ffmpeg`` on ``PATH`` (a
  small script; neither machine has the binary): it answers ``-i`` with
  a probe banner on stderr and serves raw RGB24 bytes for the decode.
  The port's parse of the banner, its frames, its truncated-frame and
  decoder-failure errors equal the JAX package's on the same bytes,
  and a clip through ``sequence._resolve_frame_source`` gives the same
  frames and rate;
- ``_require_ffmpeg`` raises the JAX package's error when no binary is
  found.
"""
from __future__ import annotations

import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import style_transfer_visualizer_tpu.media.decode as jax_decode
import style_transfer_visualizer_tpu.sequence as jax_seq
from style_transfer_visualizer_tpu_torch import sequence
from style_transfer_visualizer_tpu_torch.media import decode

_COLORS = ((255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0))


def _animated(path: Path, *, duration_ms: int = 100, **kw) -> Path:
    rng = np.random.default_rng(1)
    frames = [
        Image.fromarray(
            np.clip(
                np.array(c, np.int16) + rng.integers(-20, 20, (24, 32, 3)),
                0, 255,
            ).astype(np.uint8),
        )
        for c in _COLORS
    ]
    frames[0].save(
        path, save_all=True, append_images=frames[1:],
        duration=duration_ms, loop=0, **kw,
    )
    return path


@pytest.fixture(params=["gif", "apng", "webp"])
def clip(request, tmp_path) -> Path:
    extra = {"lossless": True} if request.param == "webp" else {}
    return _animated(tmp_path / f"clip.{request.param}", **extra)


def test_pil_frames_equal_jax(clip) -> None:
    ours = list(decode.iter_video_frames(clip))
    ref = list(jax_decode.iter_video_frames(clip))
    assert len(ours) == len(ref) == len(_COLORS)
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == np.uint8
        assert a.shape == (24, 32, 3)
        np.testing.assert_array_equal(a, b)


def test_pil_probe_equals_jax(clip) -> None:
    assert decode.is_video_file(clip)
    assert decode.probe_video(clip) == jax_decode.probe_video(clip)


@pytest.mark.parametrize("duration", [0, 40, 200])
def test_gif_rate_equals_jax(tmp_path, duration) -> None:
    clip = _animated(tmp_path / "c.gif", duration_ms=duration)
    ours = decode.probe_video(clip)
    assert ours == jax_decode.probe_video(clip)
    assert ours.fps == pytest.approx(1000 / duration if duration else 10.0)


@pytest.mark.parametrize(("stride", "cap"), [(1, None), (2, None), (1, 2),
                                             (3, 1)])
def test_extract_frames_equal_jax(tmp_path, clip, stride, cap) -> None:
    kw = {"max_frames": cap, "stride": stride}
    ours = decode.extract_frames(clip, tmp_path / "ours", **kw)
    ref = jax_decode.extract_frames(clip, tmp_path / "ref", **kw)
    assert [p.name for p in ours] == [p.name for p in ref]
    for a, b in zip(ours, ref, strict=True):
        with Image.open(a) as ia, Image.open(b) as ib:
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


@pytest.mark.parametrize(
    "path", ["missing.mp4", "dir", "still.png"],
)
def test_is_video_file_equals_jax(tmp_path, path) -> None:
    (tmp_path / "dir").mkdir()
    Image.new("RGB", (8, 8)).save(tmp_path / "still.png")
    target = tmp_path / path
    assert not decode.is_video_file(target)
    assert decode.is_video_file(target) == jax_decode.is_video_file(target)


def test_refusals_equal_jax(tmp_path) -> None:
    clip = _animated(tmp_path / "c.gif")
    for call in (
        lambda m: m.probe_video(tmp_path / "nope.gif"),
        lambda m: m.extract_frames(clip, tmp_path / "x", stride=0),
    ):
        errors = []
        for module in (decode, jax_decode):
            with pytest.raises((ValueError, FileNotFoundError)) as exc:
                call(module)
            errors.append((type(exc.value), str(exc.value)))
        assert errors[0] == errors[1]


# --- the ffmpeg path, through a stand-in process ---------------------------

_STAND_IN = """#!{python}
import os
import sys

args = sys.argv[1:]
if "-f" in args:
    with open(os.environ["STAND_IN_RAW"], "rb") as fh:
        sys.stdout.buffer.write(fh.read())
    sys.stdout.flush()
    sys.stderr.write(os.environ.get("STAND_IN_ERR", ""))
    sys.exit(int(os.environ.get("STAND_IN_RC", "0")))
sys.stderr.write(os.environ["STAND_IN_BANNER"])
sys.exit(1)
"""

_BANNER = (
    "Input #0, mov,mp4,m4a,3gp,3g2,mj2, from 'clip.mp4':\n"
    "  Duration: 00:00:01.00, start: 0.000000, bitrate: 97 kb/s\n"
    "  Stream #0:0[0x1](und): Video: h264 (High) (avc1 / 0x31637661), "
    "yuv420p(progressive), {dims} [SAR 1:1 DAR 4:3], 12 kb/s, {fps}"
    "30 tbr, 15360 tbn (default)\n"
)


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A stand-in ``ffmpeg`` first on PATH; returns a setter."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "ffmpeg"
    exe.write_text(_STAND_IN.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")

    def serve(frames: np.ndarray | bytes, *, dims="32x24", fps="25 fps, ",
              banner=None, rc=0, err=""):
        raw = tmp_path / "raw.bin"
        raw.write_bytes(
            frames if isinstance(frames, bytes) else frames.tobytes(),
        )
        monkeypatch.setenv("STAND_IN_RAW", str(raw))
        monkeypatch.setenv(
            "STAND_IN_BANNER",
            banner if banner is not None
            else _BANNER.format(dims=dims, fps=fps),
        )
        monkeypatch.setenv("STAND_IN_RC", str(rc))
        monkeypatch.setenv("STAND_IN_ERR", err)
        clip = tmp_path / "clip.mp4"
        clip.write_bytes(b"not really an mp4")
        return clip

    return serve


def _frames(n: int = 3) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, 256, (n, 24, 32, 3), dtype=np.uint8,
    )


@pytest.mark.parametrize(
    ("dims", "fps", "want"),
    [("32x24", "25 fps, ", (32, 24, 25.0)),
     ("1280x720", "29.97 fps, ", (1280, 720, 29.97)),
     ("640x360", "", (640, 360, 10.0)),
     ("64x48", "0 fps, ", (64, 48, 10.0))],
)
def test_probe_banner_parse_equals_jax(stand_in, dims, fps, want) -> None:
    clip = stand_in(b"", dims=dims, fps=fps)
    ours = decode.probe_video(clip)
    assert ours == jax_decode.probe_video(clip)
    assert (ours.width, ours.height, ours.fps) == want
    assert ours.n_frames is None


@pytest.mark.parametrize(
    "banner",
    ["Input #0, wav, from 'a.mp4':\n  Stream #0:0: Audio: pcm\n",
     "  Stream #0:0: Video: h264, yuv420p, 25 fps\n"],
)
def test_probe_refusals_equal_jax(stand_in, banner) -> None:
    clip = stand_in(b"", banner=banner)
    msgs = []
    for module in (decode, jax_decode):
        with pytest.raises(ValueError) as exc:  # noqa: PT011
            module.probe_video(clip)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_pipe_frames_equal_jax(stand_in) -> None:
    frames = _frames()
    clip = stand_in(frames)
    ours = list(decode.iter_video_frames(clip))
    ref = list(jax_decode.iter_video_frames(clip))
    assert len(ours) == len(ref) == 3
    for mine, theirs, want in zip(ours, ref, frames, strict=True):
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(mine, want)
        assert mine.flags.writeable


def test_truncated_frame_equals_jax(stand_in) -> None:
    clip = stand_in(_frames(2).tobytes()[:-7])
    msgs = []
    for module in (decode, jax_decode):
        with pytest.raises(ValueError, match="Truncated frame") as exc:
            list(module.iter_video_frames(clip))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_decoder_failure_equals_jax(stand_in) -> None:
    clip = stand_in(_frames(1), rc=3, err="moov atom not found")
    msgs = []
    for module in (decode, jax_decode):
        with pytest.raises(RuntimeError, match="moov atom") as exc:
            list(module.iter_video_frames(clip))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_clip_frame_source_equals_jax(stand_in, tmp_path) -> None:
    clip = stand_in(_frames(5), fps="12 fps, ")
    got = []
    for name, module in (("ours", sequence), ("ref", jax_seq)):
        out = tmp_path / name
        out.mkdir()
        frames, extracted, fps = module._resolve_frame_source(  # noqa: SLF001
            clip, out, max_frames=2, frame_stride=2,
        )
        assert fps == 12.0
        assert extracted is not None
        got.append([np.asarray(Image.open(p)) for p in frames])
    assert len(got[0]) == 2
    for a, b in zip(*got, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][1], _frames(5)[2])


@pytest.mark.parametrize("call", ["probe", "frames"])
def test_require_ffmpeg_raises_like_jax(tmp_path, monkeypatch, call) -> None:
    clip = tmp_path / "clip.mov"
    clip.write_bytes(b"x")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    msgs = []
    for module in (decode, jax_decode):
        with pytest.raises(RuntimeError, match="ffmpeg binary") as exc:
            if call == "probe":
                module.probe_video(clip)
            else:
                module._iter_ffmpeg_frames(  # noqa: SLF001
                    clip, module.VideoInfo(8, 8, 10.0, None),
                ).__next__()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
