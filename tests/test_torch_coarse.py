"""The port's coarse-to-fine warm start vs the JAX package, on the CPU.

- ``resolve_coarse_steps``, ``coarse_dims``, ``pyramid_dims`` and
  ``plan_pyramid``: equal over a grid of sizes (1 MP and up included)
  and budgets;
- ``resize_image`` against ``jax.image.resize(method="linear")``:
  within 1e-6 absolute on normalized images, shrinking and enlarging,
  at the 1080x1920 <-> 528x960 ratio too;
- ``coarse_init`` over two levels with every objective term: the warm
  image within 2 uint8 levels of the JAX package's once denormalized
  (the end-to-end image gate), and within 1e-6 on average. Adam's
  early steps move a pixel by about ``lr * g / (|g| + 1e-8)``, so a
  pixel whose gradient is near zero turns float32 rounding of ``g``
  into a visible, though tiny, difference;
- the repaired fault: for content of at least 1 MP,
  ``main.prepare_model_and_input`` resolves the JAX package's schedule
  and starts from the warm start (the warm start itself is captured
  with a monkeypatch: a 1 MP VGG run does not fit the CPU test budget).
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.engine import coarse as jax_coarse
from style_transfer_visualizer_tpu.image_io import normalize_image
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu_torch import image_io, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.constants import IMAGENET_STD
from style_transfer_visualizer_tpu_torch.engine import coarse
from style_transfer_visualizer_tpu_torch.engine.optimizers import StepAux
from style_transfer_visualizer_tpu_torch.engine.step import StepBundle
from style_transfer_visualizer_tpu_torch.models import vgg19

RESIZE_ATOL = 1e-6
WARM_LEVELS = 2
WARM_MEAN_ATOL = 1e-6
SIZES = [
    (64, 64), (128, 96), (512, 512), (999, 1001), (1000, 1000),
    (1024, 1024), (1080, 1920), (1920, 1080), (2160, 3840), (40, 500),
]


@pytest.mark.parametrize("size", SIZES)
def test_schedule_matches_jax(size) -> None:
    height, width = size
    for requested, steps in itertools.product((-1, 0, 3), (1, 4, 20, 1500)):
        assert coarse.resolve_coarse_steps(
            requested, height, width, steps,
        ) == jax_coarse.resolve_coarse_steps(requested, height, width, steps)
    assert coarse.coarse_dims(height, width) == jax_coarse.coarse_dims(
        height, width,
    )
    for levels in range(2, 7):
        assert coarse.pyramid_dims(
            height, width, levels,
        ) == jax_coarse.pyramid_dims(height, width, levels)
        for budget in (0, 1, 2, 5, 7, 300):
            assert coarse.plan_pyramid(
                height, width, budget, levels,
            ) == jax_coarse.plan_pyramid(height, width, budget, levels)


@pytest.mark.parametrize(
    ("source", "target"),
    [
        ((64, 64), (32, 32)),
        ((1024, 1024), (512, 512)),
        ((1080, 1920), (528, 960)),
        ((32, 32), (64, 64)),
        ((512, 512), (1024, 1024)),
        ((528, 960), (1080, 1920)),
        ((64, 48), (32, 96)),
    ],
)
def test_resize_image_matches_jax(source, target) -> None:
    rng = np.random.default_rng(sum(source))
    img = rng.uniform(size=(1, *source, 3)).astype(np.float32)
    img = np.asarray(normalize_image(jnp.asarray(img)))
    ref = jax.image.resize(
        jnp.asarray(img), (1, *target, 3), method="linear",
    )
    ours = coarse.resize_image(torch.from_numpy(img.copy()), *target)
    assert tuple(ours.shape) == (1, *target, 3)
    assert ours.is_contiguous()
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(ref), rtol=0, atol=RESIZE_ATOL,
    )


def _opt_fields(**extra):
    return {
        "steps": 3, "optimizer": "adam", "lr": 0.1, "style_layers": [0, 5],
        "content_layers": [2], "init_method": "content", "seed": 0,
        "allow_random_weights": True, "tv_w": 1e-2, "lap_w": 1e2,
        "lap_pool": 16, "style_layer_weights": [1.0, 0.5], **extra,
    }


def test_coarse_init_matches_jax() -> None:
    """Two levels (32 and 64 px of a 128 px image), content init.

    ``lap_pool=16`` leaves the 32 px level a 2x2 pooled image, so the
    Laplacian term starts at the 64 px level there as here.
    """
    rng = np.random.default_rng(40)
    content, style, extra = (
        rng.uniform(size=(1, 128, 128, 3)).astype(np.float32)
        for _ in range(3)
    )
    fields = _opt_fields(coarse_steps=3, pyramid_levels=3)
    params_j = jax_vgg19.init_random_params(jax.random.key(0))
    blend = [(style, 0.6), (extra, 0.4)]
    warm_j = jax_coarse.coarse_init(
        params_j, normalize_image(jnp.asarray(content)),
        normalize_image(jnp.asarray(style)),
        JaxConfig.model_validate({
            "optimization": fields, "hardware": {"device": "cpu"},
        }),
        jax.random.key(0),
        blend_imgs=[
            (normalize_image(jnp.asarray(img)), w) for img, w in blend
        ],
    )
    config = StyleTransferConfig(
        optimization=OptimizationConfig(**fields),
        hardware=HardwareConfig(device="cpu"),
    )

    def norm(img):
        return image_io.host_array_to_device(img, "cpu", normalize=True)

    warm = coarse.coarse_init(
        vgg19.init_random_params(0, "cpu"), norm(content), norm(style),
        config, None, blend_imgs=[(norm(img), w) for img, w in blend],
    )
    assert tuple(warm.shape) == (1, 128, 128, 3)
    diff = np.abs(warm.numpy() - np.asarray(warm_j))
    assert diff.mean() <= WARM_MEAN_ATOL
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    assert (diff * std).max() * 255 <= WARM_LEVELS


def test_coarse_init_is_none_when_off_or_too_small() -> None:
    config = StyleTransferConfig(
        optimization=OptimizationConfig(**_opt_fields(coarse_steps=0)),
        hardware=HardwareConfig(device="cpu"),
    )
    img = torch.zeros((1, 64, 64, 3))
    assert coarse.coarse_init({}, img, img, config, None) is None
    config.optimization.coarse_steps = 2
    small = torch.zeros((1, 48, 64, 3))
    assert coarse.coarse_init({}, small, small, config, None) is None


def test_a_level_past_the_band_threshold_raises(monkeypatch) -> None:
    """A level of 4,194,304 px (2048x2048) runs whole; it used to raise.

    4096x4096 content at the default two levels gets a 2048x2048 level,
    which the JAX package bands and rematerializes (the same values)
    and the port runs whole, single and batch. The level's targets and
    optimizer are stubbed (a step adds 1 to the image), so no 2048x2048
    VGG runs on the CPU.
    """
    levels = []

    def fake_targets(params, style, content, *layers):
        levels.append(tuple(content.shape))

    def fake_multi_targets(params, content, styles, *layers):
        levels.append(tuple(content.shape))

    def fake_step(params, targets, image_shape, *n_styles, **kwargs):
        def chunked_update(image, state, k):
            loss = torch.zeros((k, *n_styles))
            return image + k, state, StepAux(loss, loss, loss, loss)

        return StepBundle(None, None, chunked_update)

    monkeypatch.setattr(coarse, "compute_targets", fake_targets)
    monkeypatch.setattr(coarse, "multi_style_targets", fake_multi_targets)
    monkeypatch.setattr(coarse, "build_update_step", fake_step)
    monkeypatch.setattr(coarse, "build_multi_style_update", fake_step)
    config = StyleTransferConfig(
        optimization=OptimizationConfig(
            **_opt_fields(coarse_steps=1, lap_w=0.0),
        ),
        hardware=HardwareConfig(device="cpu"),
    )
    side = 4096
    img = torch.zeros((1, side, side, 3))
    style = torch.zeros((1, 64, 64, 3))
    warm = coarse.coarse_init({}, img, style, config, None)
    assert tuple(warm.shape) == (1, side, side, 3)
    assert float(warm.min()) == float(warm.max()) == 1.0
    warm = coarse.multi_coarse_init({}, img, [style], config, None)
    assert tuple(warm.shape) == (1, 1, side, side, 3)
    assert float(warm.min()) == float(warm.max()) == 1.0
    assert levels == [(1, 2048, 2048, 3)] * 2
    assert levels[0][1] * levels[0][2] == 4_194_304


@pytest.mark.parametrize(("size", "runs"), [(1024, True), (512, False)])
def test_single_run_takes_the_auto_warm_start(
    monkeypatch, size, runs,
) -> None:
    """The fault: the port went straight to ``init_method`` at 1 MP."""
    steps = 20
    seen = {}
    warm = torch.full((1, size, size, 3), 0.25)

    def fake_coarse_init(params, content_img, style_img, config, generator,
                         *, blend_imgs):
        opt = config.optimization
        seen["coarse_steps"] = opt.coarse_steps
        seen["schedule"] = coarse.plan_pyramid(
            size, size, opt.coarse_steps, opt.pyramid_levels,
        )
        seen["shapes"] = (tuple(content_img.shape), tuple(style_img.shape))
        return warm

    monkeypatch.setattr(main, "coarse_init", fake_coarse_init)
    # One conv layer keeps the 1 MP targets cheap; Adam keeps the
    # optimizer state at two image-sized moments.
    params = {0: vgg19.init_random_params(0, "cpu")[0]}
    config = StyleTransferConfig(
        optimization=OptimizationConfig(
            steps=steps, optimizer="adam", style_layers=[0],
            content_layers=[0], init_method="content",
        ),
        hardware=HardwareConfig(device="cpu"),
    )
    rng = np.random.default_rng(50)
    content = rng.uniform(size=(1, size, size, 3)).astype(np.float32)
    style = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    _, start = main.prepare_model_and_input(
        content, style, config, params=params,
    )
    want = jax_coarse.resolve_coarse_steps(-1, size, size, steps)
    assert config.optimization.coarse_steps == want
    if runs:
        assert want == steps // 5
        assert seen["coarse_steps"] == want
        assert seen["schedule"] == jax_coarse.plan_pyramid(
            size, size, want, 2,
        ) == [(size // 2, size // 2, want)]
        assert seen["shapes"] == ((1, size, size, 3), (1, 64, 64, 3))
        assert start is warm
    else:
        assert want == 0
        assert not seen
        np.testing.assert_allclose(
            start.numpy(),
            image_io.host_array_to_device(
                content, "cpu", normalize=True,
            ).numpy(),
        )
