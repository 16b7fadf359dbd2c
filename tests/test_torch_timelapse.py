"""The port's timelapse run end to end against the JAX package's, on the CPU.

Both ``style_transfer`` calls get the same 64x64 PNGs (seeded numpy
noise) and the same configuration: 4 L-BFGS steps, taps [0, 5]/[2],
content init, seeded weights, ``save_every=1``, the GIF with its intro
and outro, no MP4 (no ffmpeg here), a loss CSV and the plot flag on.
``Image.effect_noise`` is replaced by a seeded draw restarted before
each run, so the gallery frames can be compared. Tolerances:

- the same files, by name, and the same GIF frame count;
- the frames handed to the GIF: intro frames bit-equal (host code on
  the same input files), stylized and outro frames within 2 uint8
  levels (float32 sums in other orders over 4 steps);
- CSV losses within 1e-3 relative per row (the curve gate of the JAX
  package's ``ops/precision.py``);
- final PNGs within 2 levels.

The ``final_only`` pair writes no GIF or MP4 and still writes the PNG
and the plot. The golden test holds the port's PNG for the ``lbfgs``
configuration of ``tests/goldens_lib.py`` against
``tests/goldens/lbfgs.png`` at SSIM >= 0.98 and MAD <= 2.0.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import style_transfer_visualizer_tpu.main as jax_main
from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.media import encode as jax_encode
from style_transfer_visualizer_tpu.type_defs import (
    InputPaths as JaxInputPaths,
)
from style_transfer_visualizer_tpu_torch import cli, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.media import encode
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from tests import goldens_lib

LEVELS = 2
CURVE_RTOL = 1e-3
_OPT = {
    "steps": 4, "style_layers": [0, 5], "content_layers": [2],
    "init_method": "content", "seed": 0, "allow_random_weights": True,
}
_VIDEO = {
    "create_video": False, "create_gif": True, "save_every": 1,
    "gif_include_intro": True, "gif_include_outro": True, "fps": 2,
    "intro_duration_seconds": 1.0, "outro_duration_seconds": 1.0,
}


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
    """The frames each package hands to its GIF collector, in order."""
    seen: dict[str, list[np.ndarray]] = {"ours": [], "ref": []}
    for key, module in (("ours", encode), ("ref", jax_encode)):
        original = module.GifFrameCollector.append_data

        def append(self, frame, _orig=original, _key=key):
            seen[_key].append(np.array(frame))
            _orig(self, frame)

        monkeypatch.setattr(module.GifFrameCollector, "append_data", append)
    return seen


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(21)
    paths = []
    for name in ("content.png", "style.png"):
        path = tmp_path / name
        Image.fromarray(
            rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
        ).save(path)
        paths.append(path)
    return paths


def _configs(out: Path, *, video: dict, output: dict):
    jax_cfg = JaxConfig.model_validate({
        "optimization": {**_OPT, "coarse_steps": 0},
        "video": video,
        "hardware": {"device": "cpu"},
        "output": {"output": str(out / "ref"), **output("ref")},
    })
    cfg = StyleTransferConfig(
        output=OutputConfig(output=str(out / "ours"), **output("ours")),
        optimization=OptimizationConfig(**_OPT),
        video=VideoConfig(**video),
        hardware=HardwareConfig(device="cpu"),
    )
    return cfg, jax_cfg


def _run_both(inputs, out: Path, seeded_noise, *, video, output):
    cfg, jax_cfg = _configs(out, video=video, output=output)
    content, style = (str(p) for p in inputs)
    seeded_noise()
    image = main.style_transfer(InputPaths(content, style), cfg)
    seeded_noise()
    ref = jax_main.style_transfer(JaxInputPaths(content, style), jax_cfg)
    return image, np.asarray(ref)


def _png(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.int16)


def _csv_rows(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["step", "style_loss", "content_loss", "total_loss"]
    return np.array(rows[1:], dtype=np.float64)


def test_timelapse_matches_jax(
    tmp_path, inputs, seeded_noise, gif_frames,
) -> None:
    image, ref_image = _run_both(
        inputs, tmp_path, seeded_noise, video=_VIDEO,
        output=lambda name: {
            "log_every": 1, "log_loss": str(tmp_path / f"{name}.csv"),
        },
    )
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    names = sorted(p.name for p in ours_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    assert "timelapse_content_x_style.gif" in names
    assert "stylized_content_x_style.png" in names

    # The GIF encoder folds repeated frames into longer ones.
    gif = "timelapse_content_x_style.gif"
    with Image.open(ours_dir / gif) as a, Image.open(ref_dir / gif) as b:
        assert a.n_frames == b.n_frames > 4

    # fps 2: fade 2 + hold 2 intro frames, 1 crossfade, 4 steps, then
    # the outro (hold 2, crossfade 1, hold 2).
    ours, ref = gif_frames["ours"], gif_frames["ref"]
    assert len(ours) == len(ref) == 4 + 1 + 4 + 5
    for a, b in zip(ours[:4], ref[:4], strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours[4:], ref[4:], strict=True):
        assert a.shape == b.shape == (64, 64, 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max()
        assert diff <= LEVELS

    got = _csv_rows(tmp_path / "ours.csv")
    want = _csv_rows(tmp_path / "ref.csv")
    np.testing.assert_array_equal(got[:, 0], [1, 2, 3, 4])
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)

    png = "stylized_content_x_style.png"
    assert np.abs(_png(ours_dir / png) - _png(ref_dir / png)).max() <= LEVELS
    assert np.abs(image.numpy() - ref_image).max() * 255 <= LEVELS


def test_final_only_matches_jax(tmp_path, inputs, seeded_noise) -> None:
    image, ref_image = _run_both(
        inputs, tmp_path, seeded_noise,
        video={**_VIDEO, "create_video": True, "final_only": True},
        output=lambda name: {"log_every": 2},
    )
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    names = sorted(p.name for p in ours_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    assert names == ["loss_plot.png", "stylized_content_x_style.png"]
    png = "stylized_content_x_style.png"
    assert np.abs(_png(ours_dir / png) - _png(ref_dir / png)).max() <= LEVELS
    assert np.abs(image.numpy() - ref_image).max() * 255 <= LEVELS


def test_lbfgs_golden(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    goldens = goldens_lib.write_inputs(tmp_path / "in")
    cfg = StyleTransferConfig(
        output=OutputConfig(output=str(tmp_path / "out"), plot_losses=False),
        optimization=OptimizationConfig(
            steps=3, lr=0.5, lbfgs_history_size=4, style_layers=[0, 5],
            content_layers=[2], init_method="content",
            seed=goldens_lib.SEED, allow_random_weights=True,
        ),
        video=VideoConfig(final_only=True),
        hardware=HardwareConfig(device="cpu"),
    )
    main.style_transfer(
        InputPaths(str(goldens.content), str(goldens.style1)), cfg,
    )
    ssim, mad = goldens_lib.compare(
        tmp_path / "out" / "stylized_content_x_style1.png",
        goldens_lib.GOLDENS_DIR / "lbfgs.png",
    )
    assert ssim >= goldens_lib.SSIM_MIN
    assert mad <= goldens_lib.MAD_MAX


def test_cli_gif_csv_and_walls(tmp_path, inputs, seeded_noise) -> None:
    content, style = inputs
    out = tmp_path / "cli"
    seeded_noise()
    assert cli.main([
        "--content", str(content), "--style", str(style),
        "--steps", "2", "--save-every", "1", "--device", "cpu",
        "--allow-random-weights", "--style-layers", "0,5",
        "--content-layers", "2", "--init-method", "content",
        "--gif", "--gif-include-intro", "--gif-include-outro",
        "--no-video", "--fps", "2", "--intro-duration", "0",
        "--outro-duration", "0", "--log-loss", str(out / "loss.csv"),
        "--log-every", "1", "--compare-inputs", "--compare-result",
        "--output", str(out),
    ]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "comparison_content_x_style.png",
        "comparison_content_x_style_final.png",
        "loss.csv",
        "stylized_content_x_style.png",
        "timelapse_content_x_style.gif",
    ]
    assert len(_csv_rows(out / "loss.csv")) == 2


def test_cli_config_mapping() -> None:
    args = cli.build_parser().parse_args([
        "--content", "c.png", "--style", "s.png", "--no-plot",
        "--final-only", "--no-intro", "--intro-duration", "-3",
        "--no-final-frame-compare", "--video-mode", "postprocess",
        "--quality", "4", "--metadata-title", "T", "--gif", "--no-gif",
    ])
    cfg = cli.config_from_args(args)
    video = cfg.video
    assert (video.final_only, video.intro_enabled) == (True, False)
    assert video.intro_duration_seconds == 0.0
    assert video.final_frame_compare is False
    assert (video.mode, video.mode_override) == ("postprocess", True)
    assert (video.quality, video.metadata_title) == (4, "T")
    assert video.create_gif is False
    assert cfg.output.plot_losses is False
    default = cli.config_from_args(cli.build_parser().parse_args(
        ["--content", "c", "--style", "s", "--log-loss", "l.csv"],
    ))
    assert default.video == VideoConfig()
    assert default.output.plot_losses is False
    assert default.output.log_loss == "l.csv"
    with pytest.raises(SystemExit):
        cli.main(["--content", "c", "--style", "s", "--quality", "11"])
