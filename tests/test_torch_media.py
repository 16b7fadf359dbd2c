"""The port's host media and gallery modules against the JAX package's.

Host code runs the same numbers on both sides, so the tolerance is
zero: frames, gallery renders, comparison walls, GIF frames, the ffmpeg
command line and the raw bytes piped to it are bit-equal (the MP4
metadata's ``creation_time`` is masked). ``blend_frames`` is held
against both the JAX package's ``segments.blend_frames`` and its native
``frameops.blend_u8``, over every pair of byte values and an alpha grid
with ties. Pillow's ``Image.effect_noise`` is unseeded, so the
``seeded_noise`` fixture replaces it with a seeded draw for both sides
and restarts the draws before each render.
"""
from __future__ import annotations

import io
import re
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from style_transfer_visualizer_tpu.config import VideoConfig as JaxVideoConfig
from style_transfer_visualizer_tpu.gallery import api as jax_api
from style_transfer_visualizer_tpu.image_grid import (
    core as jax_core,
    layouts as jax_layouts,
    naming as jax_naming,
)
from style_transfer_visualizer_tpu.media import (
    encode as jax_encode,
    modes as jax_modes,
    segments as jax_segments,
    sinks as jax_sinks,
)
from style_transfer_visualizer_tpu.runtime import (
    comparison as jax_comparison,
)
from style_transfer_visualizer_tpu_torch.config import VideoConfig
from style_transfer_visualizer_tpu_torch.gallery import api
from style_transfer_visualizer_tpu_torch.image_grid import (
    core,
    layouts,
    naming,
)
from style_transfer_visualizer_tpu_torch.media import (
    encode,
    modes,
    segments,
    sinks,
)
from style_transfer_visualizer_tpu_torch.runtime import comparison


@pytest.fixture
def seeded_noise(monkeypatch):
    """Seeded ``Image.effect_noise``; call the result to restart it."""
    state = {"n": 0}

    def effect_noise(size, sigma):
        rng = np.random.default_rng(state["n"])
        state["n"] += 1
        arr = rng.normal(128.0, sigma, (size[1], size[0]))
        return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), "L")

    monkeypatch.setattr(Image, "effect_noise", effect_noise)
    return lambda: state.update(n=0)


class ListSink:
    """A sink that keeps a copy of every frame."""

    def __init__(self) -> None:
        self.frames: list[np.ndarray] = []
        self._size: tuple[int, int] | None = None

    def append_data(self, frame: np.ndarray) -> None:
        self.frames.append(np.array(frame))
        self._size = (frame.shape[1], frame.shape[0])

    def close(self) -> None:
        pass


def _equal_frames(ours: list[np.ndarray], ref: list[np.ndarray]) -> None:
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def _cfgs(**kw):
    return JaxVideoConfig.model_validate(kw), VideoConfig(**kw)


def _image_file(path: Path, size: tuple[int, int], seed: int) -> Path:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return path


# --- blend_frames -------------------------------------------------------

# Ties of the 16.16 weight ((k + 0.5) / 65536 makes alpha*65536 + 0.5 an
# integer), ties of the byte rounding (0.5 with odd differences),
# endpoints, out-of-range and NaN alphas, and the transition alphas.
_ALPHAS = [
    0.0, 1.0, 0.5, 0.25, 0.75, 1 / 3, 2 / 3, 1e-9, 1 - 1e-7,
    0.5 / 65536, 1.5 / 65536, 32767.5 / 65536, 65535.5 / 65536,
    -0.25, 1.25, float("nan"),
    *((i + 1) / 13 for i in range(12)),
    *((i + 1) / 49 for i in range(0, 48, 7)),
]


@pytest.fixture(scope="module")
def byte_pairs():
    """Every (a, b) pair of byte values, as two 256x256x3 frames."""
    a = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, axis=1)
    return (
        np.repeat(a[..., None], 3, axis=2),
        np.repeat(a.T[..., None], 3, axis=2).copy(),
    )


@pytest.mark.parametrize("alpha", _ALPHAS)
def test_blend_frames_bit_equal(byte_pairs, alpha) -> None:
    frameops = pytest.importorskip(
        "style_transfer_visualizer_tpu.native.frameops",
    )
    a, b = byte_pairs
    ours = segments.blend_frames(a, b, alpha)
    np.testing.assert_array_equal(ours, frameops.blend_u8(a, b, alpha))
    np.testing.assert_array_equal(
        ours, jax_segments.blend_frames(a, b, alpha),
    )


def test_blend_frames_random_frames_and_shape_check() -> None:
    frameops = pytest.importorskip(
        "style_transfer_visualizer_tpu.native.frameops",
    )
    rng = np.random.default_rng(3)
    a, b = (
        rng.integers(0, 256, (17, 23, 3), dtype=np.uint8) for _ in range(2)
    )
    for alpha in rng.uniform(0, 1, 50):
        np.testing.assert_array_equal(
            segments.blend_frames(a, b, alpha),
            frameops.blend_u8(a, b, alpha),
        )
    with pytest.raises(ValueError, match="share shape"):
        segments.blend_frames(a, b[:5], 0.5)


@pytest.mark.parametrize("count", [0, 1, 5])
def test_fade_transition_frames_equal(byte_pairs, count) -> None:
    a, b = (f[:40, :50] for f in byte_pairs)
    ours, ref = ListSink(), ListSink()
    segments.append_fade_transition(ours, a, b, count)
    jax_segments.append_fade_transition(ref, a, b, count)
    _equal_frames(ours.frames, ref.frames)


@pytest.mark.parametrize(("count", "cap"), [(0, 12), (3, 12), (20, 12)])
def test_crossfade_frames_equal(byte_pairs, count, cap) -> None:
    a, b = (f[:40, :50] for f in byte_pairs)
    ours, ref = ListSink(), ListSink()
    segments.append_crossfade(ours, a, b, count, max_frames=cap)
    jax_segments.append_crossfade(ref, a, b, count, max_frames=cap)
    _equal_frames(ours.frames, ref.frames)


# --- intro and outro ---------------------------------------------------

@pytest.mark.parametrize(
    ("size", "fps", "video", "gif"),
    [((64, 64), 4, True, True), ((150, 100), 3, False, True),
     ((200, 140), 2, True, False)],
)
def test_intro_segment_equal(
    tmp_path, seeded_noise, size, fps, video, gif,
) -> None:
    content = _image_file(tmp_path / "c.png", size, 1)
    style = _image_file(tmp_path / "s.png", (90, 120), 2)
    jcfg, cfg = _cfgs(fps=fps, intro_duration_seconds=0.75)
    results = []
    for seg, vc in ((segments, cfg), (jax_segments, jcfg)):
        seeded_noise()
        writer, gif_sink = ListSink(), ListSink()
        info = seg.prepare_intro_segment(
            vc, writer if video else None, (content, style),
            gif_options=seg.GifSegmentOptions(
                sink=gif_sink if gif else None, include_intro=True,
            ),
        )
        results.append((info, writer.frames, gif_sink.frames))
    (ours_info, ours_w, ours_g), (ref_info, ref_w, ref_g) = results
    np.testing.assert_array_equal(ours_info[0], ref_info[0])
    assert ours_info[1] == ref_info[1]
    assert len(ours_w) + len(ours_g) > 0
    _equal_frames(ours_w, ref_w)
    _equal_frames(ours_g, ref_g)


@pytest.mark.parametrize("writer_size", [None, (100, 70)])
def test_outro_segment_equal(tmp_path, seeded_noise, writer_size) -> None:
    content = _image_file(tmp_path / "c.png", (100, 70), 3)
    style = _image_file(tmp_path / "s.png", (64, 64), 4)
    last = np.random.default_rng(5).integers(
        0, 256, (70, 100, 3), dtype=np.uint8,
    )
    jcfg, cfg = _cfgs(fps=3, outro_duration_seconds=0.7)
    results = []
    for seg, vc in ((segments, cfg), (jax_segments, jcfg)):
        seeded_noise()
        writer, gif_sink = ListSink(), ListSink()
        writer._size = writer_size
        seg.append_final_comparison_frame(
            vc, writer, (content, style), last,
            gif_options=seg.GifSegmentOptions(
                sink=gif_sink, include_outro=True,
            ),
        )
        results.append((writer.frames, gif_sink.frames))
    assert len(results[0][0]) > 3
    _equal_frames(results[0][0], results[1][0])
    _equal_frames(results[0][1], results[1][1])


# --- video mode ----------------------------------------------------------

_HD = (1920, 1080)


@pytest.mark.parametrize(
    ("video", "size", "steps", "override"),
    [
        ({"save_every": 20}, _HD, 1500, False),
        ({"save_every": 1}, _HD, 2400, False),
        ({"save_every": 10}, (3840, 2160), 2800, False),
        ({"save_every": 1}, (2560, 1440), 2000, False),
        ({"save_every": 1, "fps": 48}, _HD, 2000, False),
        ({"save_every": 5}, _HD, 10000, False),
        ({"save_every": 1, "mode": "realtime"}, _HD, 99999, True),
        ({"mode": "postprocess"}, _HD, 10, False),
        ({"save_every": 100}, _HD, 50, False),
        ({"save_every": 2}, (512, 512), 500, False),
        ({"save_every": 1}, (0, 512), 5000, False),
    ],
)
def test_select_video_mode_equal(video, size, steps, override) -> None:
    jcfg, cfg = _cfgs(**video)
    jcfg.mode_override = cfg.mode_override = override
    ours = modes.select_video_mode(cfg, frame_size=size, total_steps=steps)
    ref = jax_modes.select_video_mode(
        jcfg, frame_size=size, total_steps=steps,
    )
    assert ours == ref


def test_ensure_rgb_uint8_equal() -> None:
    frame = np.random.default_rng(6).uniform(-20, 280, (5, 7, 3))
    np.testing.assert_array_equal(
        sinks.ensure_rgb_uint8(frame), jax_sinks.ensure_rgb_uint8(frame),
    )
    with pytest.raises(ValueError, match="RGB"):
        sinks.ensure_rgb_uint8(np.zeros((4, 4), np.uint8))


# --- encoders --------------------------------------------------------------

class _FakeProc:
    def __init__(self, cmd) -> None:
        self.cmd = cmd
        self.stdin = io.BytesIO()
        self.stdin.close = lambda: None
        self.returncode = 0

    def wait(self) -> int:
        return self.returncode


@pytest.fixture
def fake_ffmpeg(monkeypatch):
    """Record every ffmpeg command line and the bytes piped to it."""
    procs: list[_FakeProc] = []

    def fake_popen(cmd, stdin=None, stderr=None):
        del stdin, stderr
        procs.append(_FakeProc(cmd))
        return procs[-1]

    for module in (encode, jax_encode):
        monkeypatch.setattr(module, "ffmpeg_available", lambda: True)
    # Both modules call the one ``subprocess.Popen``.
    monkeypatch.setattr(encode.subprocess, "Popen", fake_popen)
    return procs


def _masked(cmd: list[str]) -> list[str]:
    return [re.sub(r"creation_time=\S+", "creation_time=*", c) for c in cmd]


def _timelapse_frames(tmp_path: Path, size: tuple[int, int]):
    rng = np.random.default_rng(7)
    return [
        rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        for _ in range(4)
    ]


@pytest.mark.parametrize("size", [(64, 48), (70, 50)])
@pytest.mark.parametrize("mode", ["realtime", "postprocess"])
def test_ffmpeg_command_and_bytes_equal(
    tmp_path, fake_ffmpeg, seeded_noise, size, mode,
) -> None:
    content = _image_file(tmp_path / "c.png", size, 8)
    style = _image_file(tmp_path / "s.png", (64, 64), 9)
    kw = {
        "fps": 4, "quality": 7, "mode": mode, "metadata_title": "T",
        "intro_duration_seconds": 0.5, "outro_duration_seconds": 0.5,
    }
    jcfg, cfg = _cfgs(**kw)
    frames = _timelapse_frames(tmp_path, size)
    for enc, seg, vc, name in (
        (encode, segments, cfg, "ours"), (jax_encode, jax_segments, jcfg, "ref"),
    ):
        seeded_noise()
        writer = enc.setup_video_writer(vc, tmp_path / name, "v.mp4")
        last, n_cross = seg.prepare_intro_segment(
            vc, writer, (content, style),
        )
        seg.append_crossfade(writer, last, frames[0], n_cross)
        for frame in frames:
            writer.append_data(frame)
        seg.append_final_comparison_frame(
            vc, writer, (content, style), frames[-1],
        )
        writer.close()
    ours, ref = fake_ffmpeg
    assert _masked(ours.cmd)[:-1] == _masked(ref.cmd)[:-1]
    assert Path(ours.cmd[-1]).name == Path(ref.cmd[-1]).name == "v.mp4"
    data = ours.stdin.getvalue()
    assert len(data) > len(frames) * size[0] * size[1] * 3
    assert data == ref.stdin.getvalue()


def test_missing_ffmpeg_raises(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(encode, "ffmpeg_available", lambda: False)
    for mode in ("realtime", "postprocess"):
        with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
            encode.setup_video_writer(
                VideoConfig(mode=mode), tmp_path, "v.mp4",
            )


def test_gif_collector_equal(tmp_path) -> None:
    frames = _timelapse_frames(tmp_path, (40, 30))
    paths = []
    for enc, name in ((encode, "ours"), (jax_encode, "ref")):
        jcfg, cfg = _cfgs(create_gif=True, fps=5)
        gif = enc.setup_gif_collector(
            cfg if enc is encode else jcfg, tmp_path / name, "t.gif",
        )
        for frame in frames:
            gif.append_data(frame)
        gif.close()
        paths.append(tmp_path / name / "t.gif")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with Image.open(paths[0]) as gif_img:
        assert gif_img.n_frames == len(frames)


# --- gallery walls and grids -------------------------------------------------

def _panels():
    return [
        Image.fromarray(
            np.random.default_rng(s).integers(
                0, 256, (h, w, 3), dtype=np.uint8,
            ),
        )
        for s, (w, h) in enumerate([(120, 90), (80, 100), (120, 90)])
    ]


@pytest.mark.parametrize(
    "kwargs",
    [
        {"target_height": 64, "pad": 12, "border_px": 2},
        {"target_size": (400, 200)},
        {"target_height": None, "target_size": (90, 300)},
    ],
)
def test_horizontal_grid_equal(kwargs) -> None:
    np.testing.assert_array_equal(
        np.asarray(layouts.make_horizontal_grid(_panels(), **kwargs)),
        np.asarray(jax_layouts.make_horizontal_grid(_panels(), **kwargs)),
    )


@pytest.mark.parametrize(
    ("layout", "size", "tone", "label", "with_result"),
    [
        ("gallery-two-across", (480, 270), "gold", "on", False),
        ("gallery-stacked-left", (480, 270), "oak", "on", True),
        ("gallery-stacked-left", (160, 120), "black", None, True),
        ("gallery-stacked-left", (300, 300), "gold", "on", False),
    ],
)
def test_gallery_comparison_equal(
    seeded_noise, layout, size, tone, label, with_result,
) -> None:
    content, style, result = _panels()
    renders = []
    for lay, mod in ((layouts, core), (jax_layouts, jax_core)):
        seeded_noise()
        renders.append(np.asarray(lay.make_gallery_comparison(
            content, style, result if with_result else None,
            target_size=size, layout=layout,
            frame=mod.FrameParams(frame_tone=tone, label=label),
        )))
    np.testing.assert_array_equal(*renders)


def test_comparison_names_equal(tmp_path) -> None:
    c, s = Path("my content.png"), Path("sty le.jpg")
    assert naming.default_comparison_name(
        c, s, tmp_path,
    ) == jax_naming.default_comparison_name(c, s, tmp_path)
    for include in (False, True):
        assert comparison.comparison_output_path(
            tmp_path, c, s, include_result=include,
        ) == jax_comparison.comparison_output_path(
            tmp_path, c, s, include_result=include,
        )


@pytest.mark.parametrize(
    "request_kw",
    [
        {"include_inputs": True, "include_result": False},
        {"include_inputs": True, "include_result": True},
        {"include_inputs": False, "include_result": True},
    ],
)
def test_comparison_walls_equal(tmp_path, seeded_noise, request_kw) -> None:
    content = _image_file(tmp_path / "content.png", (96, 64), 10)
    style = _image_file(tmp_path / "style.png", (64, 80), 11)
    saved = {}
    for comp, name in ((comparison, "ours"), (jax_comparison, "ref")):
        out = tmp_path / name
        out.mkdir()
        _image_file(out / "stylized_content_x_style.png", (96, 64), 12)
        seeded_noise()
        saved[name] = comp.render_requested_comparisons(
            content_path=content, style_path=style, output_dir=out,
            request=comp.ComparisonRequest(**request_kw),
        )
    assert [p.name for p in saved["ours"]] == [p.name for p in saved["ref"]]
    for a, b in zip(saved["ours"], saved["ref"], strict=True):
        with Image.open(a) as ia, Image.open(b) as ib:
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


def test_missing_result_is_skipped_alike(tmp_path) -> None:
    content = _image_file(tmp_path / "content.png", (64, 64), 13)
    style = _image_file(tmp_path / "style.png", (64, 64), 14)
    for comp in (comparison, jax_comparison):
        assert comp.render_requested_comparisons(
            content_path=content, style_path=style,
            output_dir=tmp_path / "empty",
            request=comp.ComparisonRequest(
                include_inputs=False, include_result=True,
            ),
        ) == []


@pytest.mark.parametrize(
    ("fn", "text"),
    [
        ("positive_int", "12"), ("positive_int", "0"),
        ("positive_int", "x"), ("size_2d", "640x480"),
        ("size_2d", "640X48x"), ("size_2d", "axb"), ("size_2d", "0x5"),
        ("parse_wall_color", "#3c434a"), ("parse_wall_color", "#12345"),
        ("parse_wall_color", "zz3456"),
    ],
)
def test_gallery_option_parsers_equal(fn, text) -> None:
    def outcome(module):
        try:
            return getattr(module, fn)(text)
        except ValueError as exc:
            return f"ValueError: {exc}"

    assert outcome(api) == outcome(jax_api)
