"""The port's blend sweep vs the JAX package's, on the CPU.

- ``sweep_weights``: the JAX package's rows exactly, every row convex
  with at most two non-zero weights, frame 0 pure style 0 and the last
  frame pure last style; the same refusals;
- a one-hot row's blended targets are that style's, bit for bit;
- ``stylize_blend_sweep`` end to end at 64x64 with Adam: each frame's
  per-step loss curve within 1e-3 relative of the JAX run's and each
  frame's PNG within 2 uint8 levels, each JAX frame started from the
  port's start image of that frame (``tests/torch_pipelines.
  trace_frames`` says why), each port frame from the last one's image;
  the same file names, with 2 and 3 styles, color matching, luminance
  color and the Laplacian term; frame 0 is ``main.run_style_transfer`` of style 0 alone, bit for
  bit (PNG and final loss), with the shipped L-BFGS and a random start.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import style_transfer_visualizer_tpu.blend_sweep as jax_sweep
from style_transfer_visualizer_tpu_torch import blend_sweep, image_io, main
from style_transfer_visualizer_tpu_torch.models import features, vgg19
from tests import goldens_lib
from tests.torch_pipelines import (
    assert_curves,
    assert_pngs_close,
    jax_config,
    png,
    port_config,
    trace_frames,
)


@pytest.mark.parametrize("n_styles", [2, 3, 4])
@pytest.mark.parametrize("n_frames", [2, 3, 5, 8])
def test_sweep_weights_match_jax(n_styles, n_frames) -> None:
    ours = blend_sweep.sweep_weights(n_styles, n_frames)
    assert ours == jax_sweep.sweep_weights(n_styles, n_frames)
    assert len(ours) == n_frames
    assert ours[0] == [1.0] + [0.0] * (n_styles - 1)
    assert ours[-1] == [0.0] * (n_styles - 1) + [1.0]
    for row in ours:
        assert all(w >= 0 for w in row)
        assert sum(row) == pytest.approx(1.0)
        assert sum(w != 0 for w in row) <= 2  # noqa: PLR2004


@pytest.mark.parametrize(("n_styles", "n_frames"), [(1, 4), (3, 1), (0, 0)])
def test_sweep_weights_refuse_like_jax(n_styles, n_frames) -> None:
    msgs = []
    for fn in (blend_sweep.sweep_weights, jax_sweep.sweep_weights):
        with pytest.raises(ValueError) as exc:  # noqa: PT011
            fn(n_styles, n_frames)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_one_hot_rows_give_that_style_exactly() -> None:
    params = vgg19.init_random_params(0, "cpu")
    rng = np.random.default_rng(3)

    def img():
        return image_io.host_array_to_device(
            rng.uniform(size=(1, 32, 32, 3)).astype(np.float32), "cpu",
            normalize=True,
        )

    content = img()
    per_style = [
        features.compute_targets(
            params, img(), content, (0, 5), (2,) if i == 0 else (),
        )
        for i in range(3)
    ]
    rows = blend_sweep.sweep_weights(3, 5)
    for frame, style in ((0, 0), (2, 1), (4, 2)):
        mixed = features.blend_targets(per_style, rows[frame])
        for idx, gram in per_style[style].style_grams.items():
            assert torch.equal(mixed.style_grams[idx], gram)
        assert mixed.content_feats is per_style[0].content_feats


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("STV_NO_XLA_CACHE", "1")
    return goldens_lib.write_inputs(tmp_path / "in")


_E2E = {
    "two-styles": ({}, 2, 3),
    "three-styles-match-lap": (
        {"preserve_color": "match", "lap_w": 10.0, "lap_pool": 2}, 3, 4,
    ),
    "luminance-tv": ({"preserve_color": "luminance", "tv_w": 0.1}, 2, 2),
}


@pytest.mark.parametrize("mode", list(_E2E))
def test_sweep_curves_match_jax(tmp_path, inputs, monkeypatch, mode) -> None:
    opt, n_styles, n_frames = _E2E[mode]
    styles = [inputs.style1, inputs.style2, inputs.content][:n_styles]
    ours_c = trace_frames(monkeypatch, blend_sweep)
    ours = blend_sweep.stylize_blend_sweep(
        inputs.content, styles, port_config(tmp_path / "ours", **opt),
        n_frames=n_frames, sweep_steps=2,
    )
    ref_c = trace_frames(monkeypatch, jax_sweep, replay=ours_c)
    ref = jax_sweep.stylize_blend_sweep(
        inputs.content, styles, jax_config(tmp_path / "ref", **opt),
        n_frames=n_frames, sweep_steps=2,
    )
    names = [f"sweep_{i:04d}.png" for i in range(n_frames)]
    assert [p.name for p in ours.frame_paths] == names
    assert [p.name for p in ref.frame_paths] == names
    assert ours.video_path.name == ref.video_path.name
    assert ours.video_path.is_file()
    assert ours.total_steps == ref.total_steps == 3 + 2 * (n_frames - 1)
    assert [len(c) for c in ours_c.curves] == [3] + [2] * (n_frames - 1)
    ours_c.assert_carried()
    assert_curves(ours_c, ref_c)
    np.testing.assert_allclose(
        ours.frame_losses, ref.frame_losses, rtol=1e-3,
    )
    for a, b in zip(ours.frame_paths, ref.frame_paths, strict=True):
        assert_pngs_close(a, b)


def test_frame0_is_the_single_run_of_style0(tmp_path, inputs) -> None:
    opt = {"optimizer": "lbfgs", "lr": 1.0, "init_method": "random"}
    result = blend_sweep.stylize_blend_sweep(
        inputs.content, [inputs.style1, inputs.style2],
        port_config(tmp_path / "sweep", **opt), n_frames=2, sweep_steps=2,
    )
    config = port_config(tmp_path / "one", **opt)
    config.output.log_every = 1
    image, history = main.run_style_transfer(
        image_io.load_image_to_host_array(inputs.content),
        image_io.load_image_to_host_array(inputs.style1),
        config,
    )
    np.testing.assert_array_equal(
        png(result.frame_paths[0]), image_io.pack_uint8_frame(image).numpy(),
    )
    assert result.frame_losses[0] == history["total_loss"][-1]


@pytest.mark.parametrize(
    ("case", "kwargs"),
    [("one-style", {"n_frames": 3}), ("one-frame", {"n_frames": 1}),
     ("no-steps", {"n_frames": 3, "sweep_steps": 0}),
     ("missing-style", {"n_frames": 3})],
)
def test_sweep_refusals_match_jax(tmp_path, inputs, case, kwargs) -> None:
    styles = [inputs.style1, inputs.style2]
    if case == "one-style":
        styles = styles[:1]
    elif case == "missing-style":
        styles = [inputs.style1, tmp_path / "nope.png"]
    errors = []
    for module, make in (
        (blend_sweep, port_config), (jax_sweep, jax_config),
    ):
        with pytest.raises((ValueError, FileNotFoundError)) as exc:
            module.stylize_blend_sweep(
                inputs.content, styles, make(tmp_path / "o"), **kwargs,
            )
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]
