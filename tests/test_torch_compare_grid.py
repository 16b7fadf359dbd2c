"""``compare-grid-torch`` against the JAX package's ``compare-grid``.

The same argv goes through both packages' ``gallery.cli.main`` on the
same seeded PNGs: the plain three-panel grid and each gallery layout,
with labels, frame styles, a wall color and an exact target size; the
written PNGs are equal pixel for pixel. Pillow's ``Image.effect_noise``
(the wall's grain and the frames' wood streaks) is unseeded, so both
renders draw it from the same seeded stand-in, restarted for each.
The usage errors exit 2 in both, and the tool path
``tools/compare_grid.py`` is the same CLI.
"""
from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from style_transfer_visualizer_tpu.gallery import cli as jax_cli
from style_transfer_visualizer_tpu_torch.gallery import cli
from style_transfer_visualizer_tpu_torch.tools import compare_grid


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
def panels(tmp_path):
    rng = np.random.default_rng(70)
    paths = {}
    for name, shape in (("content", (96, 128)), ("style", (80, 80)),
                        ("result", (96, 128))):
        paths[name] = tmp_path / f"{name}.png"
        Image.fromarray(
            rng.integers(0, 256, (*shape, 3), dtype=np.uint8),
        ).save(paths[name])
    return paths


@pytest.mark.parametrize(
    "extra",
    [
        ["--target-height", "64", "--pad", "4", "--border-px", "2"],
        ["--layout", "gallery-two-across", "--show-labels"],
        ["--layout", "gallery-stacked-left", "--frame-style", "oak",
         "--wall", "#202830"],
        ["--layout", "gallery-two-across", "--target-size", "320x180",
         "--frame-style", "black"],
        ["--target-size", "300x120", "--show-labels"],
    ],
)
def test_walls_are_pixel_equal(
    tmp_path, panels, seeded_noise, extra,
) -> None:
    base = ["--content", str(panels["content"]), "--style",
            str(panels["style"]), "--result", str(panels["result"]), *extra]
    outs = {}
    for name, entry in (("ours", cli.main), ("ref", jax_cli.main)):
        outs[name] = tmp_path / f"{name}.png"
        seeded_noise()
        assert entry([*base, "--out", str(outs[name])]) == 0
    ours, ref = (np.asarray(Image.open(outs[k])) for k in ("ours", "ref"))
    assert ours.shape == ref.shape
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize(
    "argv",
    [
        ["--content", "c.png", "--style", "s.png"],
        ["--content", "c.png", "--style", "s.png", "--result", "r.png",
         "--pad", "0"],
        ["--content", "c.png", "--style", "s.png", "--result", "r.png",
         "--target-size", "12"],
    ],
)
def test_usage_errors_exit_like_jax(argv) -> None:
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    assert ours.value.code == ref.value.code == 2


def test_the_tool_path_is_the_cli() -> None:
    assert compare_grid.main is cli.main
    assert compare_grid.build_parser is cli.build_parser
    assert compare_grid.size_2d("4x3") == (4, 3)
