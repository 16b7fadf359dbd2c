"""The port's single run end to end on the golden corpus, on the CPU.

For the ``single``, ``coarse``, ``blend``, ``vgg16`` and
``preserve_luminance`` modes of ``tests/goldens_lib.py``, the port's
``main.style_transfer`` runs on ``goldens_lib.write_inputs`` with
``goldens_lib``'s configuration (Adam, 3 steps, taps [0, 5]/[2], content
init, seeded weights, 64x64), and so does the JAX package's. Gates:

- the committed ``tests/goldens/<mode>.png`` at SSIM >= 0.98 and MAD <=
  2.0 (``goldens_lib``'s bounds);
- the JAX run's PNG within 2 uint8 levels;
- the per-step loss curve (a CSV row a step) within 1e-3 relative of
  the JAX run's (the curve gate of the JAX package's
  ``ops/precision.py``).

A timelapse variant (GIF, ``save_every=1``, ``preserve_color=
"luminance"``) checks that the frames handed to the GIF are recolored:
within 2 levels of the JAX package's frames, and with the content's
chrominance wherever no channel is clipped.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import style_transfer_visualizer_tpu.main as jax_main
from style_transfer_visualizer_tpu.media import encode as jax_encode
from style_transfer_visualizer_tpu.type_defs import (
    InputPaths as JaxInputPaths,
)
from style_transfer_visualizer_tpu_torch import main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.media import encode
from style_transfer_visualizer_tpu_torch.ops.color import RGB_TO_YIQ
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from tests import goldens_lib

LEVELS = 2
CURVE_RTOL = 1e-3
# Chrominance of a recolored uint8 frame: the pack rounds each channel
# by up to half a level.
CHROMA_ATOL = 1.5 / 255
_BASE = {
    "steps": 3, "optimizer": "adam", "lr": 0.1, "style_layers": [0, 5],
    "content_layers": [2], "init_method": "content",
    "seed": goldens_lib.SEED, "allow_random_weights": True,
    "coarse_steps": 0,
}
#: mode -> (optimization overrides, blended)
MODES = {
    "single": ({}, False),
    "coarse": ({"coarse_steps": 2}, False),
    "blend": ({}, True),
    "vgg16": (
        {"model": "vgg16", "style_layers": [0, 5, 10],
         "content_layers": [12]},
        False,
    ),
    "preserve_luminance": ({"preserve_color": "luminance"}, False),
}


@pytest.fixture
def golden_inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return goldens_lib.write_inputs(tmp_path / "in")


def _port_config(out: Path, opt: dict, video: dict, output: dict):
    return StyleTransferConfig(
        output=OutputConfig(output=str(out), plot_losses=False, **output),
        optimization=OptimizationConfig(**{**_BASE, **opt}),
        video=VideoConfig(**video),
        hardware=HardwareConfig(device="cpu"),
    )


def _jax_config(out: Path, opt: dict, video: dict, output: dict):
    cfg = goldens_lib._config(out, **opt)  # noqa: SLF001 - the corpus's own
    cfg.video = type(cfg.video).model_validate(video)
    for key, value in output.items():
        setattr(cfg.output, key, value)
    return cfg


def _run_both(inputs, root: Path, opt, *, blended, video, output):
    """Run both packages; return (port image, JAX image)."""
    paths = (str(inputs.content), str(inputs.style1))
    blend = None
    if blended:
        blend = [(str(inputs.style1), 0.7), (str(inputs.style2), 0.3)]
    image = main.style_transfer(
        InputPaths(*paths),
        _port_config(root / "ours", opt, video, output("ours")),
        style_blend=blend,
    )
    ref = jax_main.style_transfer(
        JaxInputPaths(*paths),
        _jax_config(root / "ref", opt, video, output("ref")),
        style_blend=blend,
    )
    return image, np.asarray(ref)


def _png(path: Path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.int16)


def _curve(path: Path) -> np.ndarray:
    with path.open() as fh:
        rows = list(csv.reader(fh))
    return np.array(rows[1:], dtype=np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_golden_and_jax_parity(tmp_path, golden_inputs, mode) -> None:
    opt, blended = MODES[mode]
    image, ref_image = _run_both(
        golden_inputs, tmp_path, opt, blended=blended,
        video={"final_only": True},
        output=lambda name: {
            "log_every": 1, "log_loss": str(tmp_path / f"{name}.csv"),
        },
    )
    png = (
        "stylized_content_x_style1+style2.png" if blended
        else "stylized_content_x_style1.png"
    )
    ours_png = tmp_path / "ours" / png
    ssim, mad = goldens_lib.compare(
        ours_png, goldens_lib.GOLDENS_DIR / f"{mode}.png",
    )
    assert ssim >= goldens_lib.SSIM_MIN
    assert mad <= goldens_lib.MAD_MAX
    assert np.abs(_png(ours_png) - _png(tmp_path / "ref" / png)).max() <= (
        LEVELS
    )
    assert np.abs(image.numpy() - ref_image).max() * 255 <= LEVELS
    got, want = _curve(tmp_path / "ours.csv"), _curve(tmp_path / "ref.csv")
    np.testing.assert_array_equal(got[:, 0], [1, 2, 3])
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=CURVE_RTOL)


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


def test_luminance_timelapse_frames_are_recolored(
    tmp_path, golden_inputs, gif_frames,
) -> None:
    _run_both(
        golden_inputs, tmp_path, {"preserve_color": "luminance"},
        blended=False,
        video={"create_video": False, "create_gif": True, "save_every": 1},
        output=lambda name: {},
    )
    gif = "timelapse_content_x_style1.gif"
    assert (tmp_path / "ours" / gif).is_file()
    ours, ref = gif_frames["ours"], gif_frames["ref"]
    assert len(ours) == len(ref) == 3
    content = _png(golden_inputs.content).astype(np.float64) / 255
    iq_content = content @ RGB_TO_YIQ[1:].T
    for a, b in zip(ours, ref, strict=True):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= (
            LEVELS
        )
        unclipped = ((a > 0) & (a < 255)).all(axis=-1)
        assert unclipped.mean() > 0.5
        iq = (a.astype(np.float64) / 255) @ RGB_TO_YIQ[1:].T
        err = np.abs(iq - iq_content)[unclipped].max()
        assert err <= CHROMA_ATOL
