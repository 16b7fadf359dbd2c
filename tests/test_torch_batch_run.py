"""The port's multi-style batch end to end vs the JAX package, on the CPU.

Both packages' ``multi_style_transfer`` get the same PNGs (seeded numpy
noise: a 64x64 content and two styles of two sizes) and the same
configuration: 4 L-BFGS steps, taps [0, 5]/[2], content init, seeded
weights, a GIF per style with its intro and outro, no MP4 (no ffmpeg
here). ``Image.effect_noise`` is replaced by a seeded draw restarted
before each run, so the gallery frames can be compared. Tolerances:

- the same files, by name;
- each style's PNG within MAD <= 2 and SSIM >= 0.98 of JAX's (the
  golden gate of ``tests/goldens_lib.py``);
- each style's CSV rows equal in steps and within 1e-3 relative in
  values (the curve gate of the JAX package's ``ops/precision.py``);
- each style's GIF: the same number of frames handed to it, intro and
  outro included, and the same frame count in the written file.

The CLI pair (``--styles`` without ``--style-blend``, the loss plots
on) writes the same names and PNGs within the same gate. The loop's
own contract is checked with stand-in sinks: frames per style in step
order, the last one the packed final image, and a sink that fails to
close is raised only after every PNG is saved.
"""
from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import style_transfer_visualizer_tpu.main as jax_main
from style_transfer_visualizer_tpu import cli as jax_cli
from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.media import encode as jax_encode
from style_transfer_visualizer_tpu_torch import cli, image_io, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.media import encode
from tests import goldens_lib

CURVE_RTOL = 1e-3
STEPS = 4
_OPT = {
    "steps": STEPS, "style_layers": [0, 5], "content_layers": [2],
    "init_method": "content", "seed": 0, "allow_random_weights": True,
    "lbfgs_history_size": 4,
}
_VIDEO = {
    "create_video": False, "create_gif": True, "save_every": 1,
    "gif_include_intro": True, "gif_include_outro": True, "fps": 2,
    "intro_duration_seconds": 1.0, "outro_duration_seconds": 1.0,
}
STYLES = ("soft", "bold")


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


@pytest.fixture
def gif_frames(monkeypatch):
    """Frames each package hands to each GIF, by package and file name."""
    seen: dict[str, dict[str, list]] = {
        "ours": defaultdict(list), "ref": defaultdict(list),
    }
    for key, module in (("ours", encode), ("ref", jax_encode)):
        original = module.GifFrameCollector.append_data

        def append(self, frame, _orig=original, _key=key):
            seen[_key][self._output_path.name].append(np.array(frame))
            _orig(self, frame)

        monkeypatch.setattr(module.GifFrameCollector, "append_data", append)
    return seen


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(31)
    shapes = {"content": (64, 64), "soft": (64, 64), "bold": (96, 96)}
    paths = {}
    for name, (h, w) in shapes.items():
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


def _csv_rows(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["step", "style_loss", "content_loss", "total_loss"]
    return np.array(rows[1:], dtype=np.float64)


def _assert_pngs_close(ours_dir: Path, ref_dir: Path) -> None:
    for style in STYLES:
        name = f"stylized_content_x_{style}.png"
        ssim, mad = goldens_lib.compare(ours_dir / name, ref_dir / name)
        assert ssim >= goldens_lib.SSIM_MIN, (name, ssim)
        assert mad <= goldens_lib.MAD_MAX, (name, mad)


def test_batch_run_matches_jax(
    tmp_path, inputs, seeded_noise, gif_frames,
) -> None:
    content = str(inputs["content"])
    styles = [str(inputs[s]) for s in STYLES]
    out = {name: tmp_path / name for name in ("ours", "ref")}
    cfg = StyleTransferConfig(
        output=OutputConfig(
            output=str(out["ours"]), log_every=1,
            log_loss=str(tmp_path / "ours.csv"),
        ),
        optimization=OptimizationConfig(**_OPT),
        video=VideoConfig(**_VIDEO),
        hardware=HardwareConfig(device="cpu"),
    )
    jax_cfg = JaxConfig.model_validate({
        "optimization": {**_OPT, "coarse_steps": 0},
        "video": _VIDEO,
        "hardware": {"device": "cpu"},
        "output": {
            "output": str(out["ref"]), "log_every": 1,
            "log_loss": str(tmp_path / "ref.csv"),
        },
    })
    seeded_noise()
    saved = main.multi_style_transfer(content, styles, cfg)
    seeded_noise()
    ref_saved = jax_main.multi_style_transfer(content, styles, jax_cfg)
    assert [p.name for p in saved] == [p.name for p in ref_saved]

    names = sorted(p.name for p in out["ours"].iterdir())
    assert names == sorted(p.name for p in out["ref"].iterdir())
    assert names == sorted(
        [f"stylized_content_x_{s}.png" for s in STYLES]
        + [f"timelapse_content_x_{s}.gif" for s in STYLES],
    )
    _assert_pngs_close(out["ours"], out["ref"])

    for style in STYLES:
        got = _csv_rows(tmp_path / f"ours_{style}.csv")
        want = _csv_rows(tmp_path / f"ref_{style}.csv")
        np.testing.assert_array_equal(got[:, 0], list(range(1, STEPS + 1)))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)

        gif = f"timelapse_content_x_{style}.gif"
        ours, ref = gif_frames["ours"][gif], gif_frames["ref"][gif]
        # fps 2: fade 2 + hold 2 intro frames, 1 crossfade, 4 steps,
        # then the outro (hold 2, crossfade 1, hold 2).
        assert len(ours) == len(ref) == 4 + 1 + STEPS + 5
        for a, b in zip(ours[:4], ref[:4], strict=True):
            np.testing.assert_array_equal(a, b)
        with Image.open(out["ours"] / gif) as a, Image.open(
            out["ref"] / gif,
        ) as b:
            assert a.n_frames == b.n_frames


def test_batch_cli_matches_jax(tmp_path, inputs, seeded_noise) -> None:
    """``--styles a,b`` without ``--style-blend``; plots on, no CSV."""
    base = [
        "--content", str(inputs["content"]),
        "--styles", ",".join(str(inputs[s]) for s in STYLES),
        "--steps", str(STEPS), "--device", "cpu", "--allow-random-weights",
        "--style-layers", "0,5", "--content-layers", "2",
        "--init-method", "content", "--lbfgs-history-size", "4",
        "--no-video", "--log-every", "2",
    ]
    seeded_noise()
    assert cli.main([*base, "--output", str(tmp_path / "ours")]) == 0
    seeded_noise()
    jax_cli.run_from_args(
        jax_cli.build_arg_parser().parse_args(
            [*base, "--output", str(tmp_path / "ref")],
        ),
    )
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(
        [f"stylized_content_x_{s}.png" for s in STYLES]
        + [f"loss_plot_{s}.png" for s in STYLES],
    )
    _assert_pngs_close(tmp_path / "ours", tmp_path / "ref")


class _Sink:
    """An in-memory frame sink; ``fail`` makes its close raise."""

    def __init__(self, fail: bool = False) -> None:
        self.frames: list[np.ndarray] = []
        self.fail = fail
        self.closed = False

    def append_data(self, frame: np.ndarray) -> None:
        self.frames.append(np.array(frame))

    def close(self) -> None:
        self.closed = True
        if self.fail:
            msg = "encoder failed"
            raise OSError(msg)


def _loop_config(out: Path, steps: int, save_every: int):
    return StyleTransferConfig(
        output=OutputConfig(output=str(out), log_every=2, plot_losses=False),
        optimization=OptimizationConfig(
            **{**_OPT, "steps": steps, "optimizer": "adam", "lr": 0.05},
        ),
        video=VideoConfig(
            create_video=True, create_gif=True, save_every=save_every,
        ),
        hardware=HardwareConfig(device="cpu"),
    )


@pytest.mark.parametrize(("steps", "save_every"), [(6, 2), (5, 2)])
def test_loop_fans_frames_out_per_style(tmp_path, steps, save_every) -> None:
    """Frames at the cadence, plus the final image off the cadence."""
    rng = np.random.default_rng(33)
    content = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    styles = [
        rng.uniform(size=shape).astype(np.float32)
        for shape in ((1, 32, 32, 3), (1, 24, 40, 3), (1, 32, 32, 3))
    ]
    cfg = _loop_config(tmp_path, steps, save_every)
    bundle, images = main.prepare_multi_style(content, styles, cfg)
    sinks: dict[str, _Sink] = {}

    def make_sink(kind: str, name: str) -> _Sink:
        assert kind in {"gif", "mp4"}
        sinks[name] = _Sink()
        return sinks[name]

    seen_steps: list[int] = []
    final, _, errors = main.run_multi_style_loop(
        bundle, images, cfg, tmp_path, ["a", "b", "c"],
        make_sink=make_sink,
        on_step_end=lambda step, _imgs, _aux: seen_steps.append(step),
    )
    assert errors == []
    assert seen_steps == list(range(1, steps + 1))
    # Realtime is promoted: S streaming encoders would contend.
    assert cfg.video.mode == "postprocess"
    want = steps // save_every + (1 if steps % save_every else 0)
    packed = image_io.pack_uint8_frames_batch(
        image_io.prepare_image_for_output(final, normalize=True),
    ).numpy()
    for i, style in enumerate("abc"):
        for kind in ("gif", "mp4"):
            sink = sinks[f"timelapse_content_x_{style}.{kind}"]
            assert sink.closed
            assert len(sink.frames) == want
            assert all(f.shape == (32, 32, 3) for f in sink.frames)
            np.testing.assert_array_equal(sink.frames[-1], packed[i])


def test_sink_close_error_raises_after_the_pngs(
    tmp_path, inputs, monkeypatch,
) -> None:
    """Every sink is closed and every PNG saved before the error."""
    sinks: list[_Sink] = []

    def make(config, output_path, kind, name):
        del config, output_path, kind
        sinks.append(_Sink(fail=name.endswith("soft.gif")))
        return sinks[-1]

    monkeypatch.setattr(main, "_default_sink", make)
    cfg = _loop_config(tmp_path / "out", 2, 1)
    cfg.video.create_video = False
    cfg.video.intro_enabled = False
    with pytest.raises(OSError, match="encoder failed"):
        main.multi_style_transfer(
            str(inputs["content"]), [str(inputs[s]) for s in STYLES], cfg,
        )
    assert len(sinks) == 2
    assert all(s.closed for s in sinks)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        f"stylized_content_x_{s}.png" for s in sorted(STYLES)
    ]
