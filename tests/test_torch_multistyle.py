"""The port's multi-style batch, part by part, vs the JAX package on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and
its counterpart in the port (the JAX side over a style mesh of the CPU
devices that ``tests/conftest.py`` forces). Seeded VGG19 weights, taps
[0, 5]/[2], 32x32 content, styles of two sizes. Tolerances, each set
from float32 with sums in different orders:

- the batched Gram (plain version) against ``jax.vmap(gram_matrix)``
  and against the single ``gram_plain`` per image, clamp idle and
  active: 1e-6 relative;
- per-image TV and Laplacian terms against the single ones: 1e-6;
- ``multi_style_targets``: Grams 1e-5 relative (through the VGG convs,
  as ``tests/test_torch_slice.py`` holds the loss), content features
  1e-5, shapes equal and the content features a broadcast view;
- ``build_multi_style_update`` against JAX's for L-BFGS (two-loop and
  compact, float32 and bfloat16 ring) and Adam, with TV, Laplacian and
  per-layer style weights, 5 steps: each style's loss curve within
  1e-3 relative per step (the curve gate of the JAX package's
  ``ops/precision.py``);
- the batched L-BFGS and Adam at S = 1 against the single step, 3
  steps: losses and images within 1e-6 relative;
- per-style masks: on quadratics where one style starts at its optimum
  (``done`` at once) and another runs inner iterations, each style's
  image, ring position and counters equal its own single run's
  (within 1e-6);
- batch invariance: with the conv run image by image (as the card's
  kernel plans it), each style of a 6-step batch of 2 ends on exactly
  its single run's image, for L-BFGS (both directions) and Adam with
  every term; the losses, reduced per image, within 1e-6;
- the batched warm start: for content of 1 MP or more the port
  resolves the JAX package's schedule (captured with a monkeypatch, as
  ``tests/test_torch_coarse.py`` does: a 1 MP VGG run does not fit the
  CPU test budget), and at 128 px two levels run against JAX's
  ``_multi_initial_images``: each warm image within 2 uint8 levels once
  denormalized, 1e-6 on average.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import style_transfer_visualizer_tpu.main as jax_main
from style_transfer_visualizer_tpu.config import (
    StyleTransferConfig as JaxConfig,
)
from style_transfer_visualizer_tpu.engine import coarse as jax_coarse
from style_transfer_visualizer_tpu.image_io import normalize_image
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.ops import lap as jax_lap
from style_transfer_visualizer_tpu.ops.gram import gram_matrix as jax_gram
from style_transfer_visualizer_tpu.parallel import multistyle as jax_ms
from style_transfer_visualizer_tpu.parallel.mesh import create_mesh
from style_transfer_visualizer_tpu_torch import image_io, main
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    StyleTransferConfig,
)
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
    IMAGENET_STD,
)
from style_transfer_visualizer_tpu_torch.engine import coarse, optimizers
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models import vgg19
from style_transfer_visualizer_tpu_torch.models.features import (
    compute_targets,
)
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram, lap, tv
from style_transfer_visualizer_tpu_torch.parallel import multistyle

ELEM_RTOL = 1e-6
TARGET_RTOL = 1e-5
CURVE_RTOL = 1e-3
SAME_RTOL = 1e-6
WARM_LEVELS = 2
WARM_MEAN_ATOL = 1e-6
STYLE, CONTENT = (0, 5), (2,)
HIGH = jax.lax.Precision.HIGHEST


def _uniform(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    """Normalized content (32x32) and two styles of two sizes."""
    content = _uniform(1, (1, 32, 32, 3))
    styles = [_uniform(2, (1, 32, 32, 3)), _uniform(3, (1, 40, 48, 3))]
    return content, styles


@pytest.fixture(scope="module")
def jax_params():
    return jax_vgg19.init_random_params(jax.random.key(0))


@pytest.fixture(scope="module")
def torch_params():
    return vgg19.init_random_params(0, "cpu")


def _norm_t(img: np.ndarray) -> torch.Tensor:
    return image_io.host_array_to_device(img, "cpu", normalize=True)


def _norm_j(img: np.ndarray) -> jax.Array:
    return normalize_image(jnp.asarray(img))


# --- the batched Gram ----------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 130.0])
def test_batched_gram_plain_matches_jax_vmap(scale) -> None:
    feats = np.random.default_rng(4).normal(
        size=(3, 1, 8, 8, 16),
    ).astype(np.float32) * scale
    ref = np.asarray(jax.vmap(jax_gram)(jnp.asarray(feats)))
    ours = gram.gram_matrix_batched(torch.from_numpy(feats[:, 0].copy()))
    assert tuple(ours.shape) == (3, 16, 16)
    np.testing.assert_allclose(
        ours.numpy(), ref, rtol=ELEM_RTOL,
        atol=ELEM_RTOL * np.abs(ref).max(),
    )
    flat = torch.from_numpy(feats.reshape(3, 64, 16))
    raw, g = gram.gram_plain_batched(flat, GRAM_MATRIX_CLAMP_MAX, 64 * 16)
    assert bool((raw > GRAM_MATRIX_CLAMP_MAX).any()) == (scale > 1)
    for i in range(3):
        raw_1, g_1 = gram.gram_plain(flat[i], GRAM_MATRIX_CLAMP_MAX, 64 * 16)
        assert torch.equal(raw[i], raw_1)
        assert torch.equal(g[i], g_1)


@pytest.mark.parametrize("scale", [1.0, 130.0])
def test_batched_gram_backward_is_per_image(scale) -> None:
    """Image s's gradient comes from its own Gram, as under ``vmap``."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 1, 6, 5, 8)).astype(np.float32) * scale
    cot = rng.normal(size=(2, 8, 8)).astype(np.float32)
    _, vjp = jax.vjp(jax.vmap(jax_gram), jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(feats[:, 0].copy()).requires_grad_(True)
    gram.gram_matrix_batched(x).backward(torch.from_numpy(cot))
    ref = np.asarray(ref)[:, 0]
    np.testing.assert_allclose(
        x.grad.numpy(), ref, rtol=ELEM_RTOL,
        atol=ELEM_RTOL * np.abs(ref).max(),
    )


def test_per_image_terms_match_the_single_ones() -> None:
    imgs = torch.from_numpy(
        np.random.default_rng(6).normal(size=(3, 24, 20, 3)).astype(
            np.float32,
        ),
    )
    target = lap.lap_response(imgs[:1] * 0.5, 4)
    tv_each = tv.tv_loss_per_image(imgs)
    lap_each = lap.lap_loss_per_image(imgs, target, 4)
    for i in range(3):
        np.testing.assert_allclose(
            float(tv_each[i]), float(tv.tv_loss(imgs[i:i + 1])),
            rtol=ELEM_RTOL,
        )
        np.testing.assert_allclose(
            float(lap_each[i]),
            float(lap.lap_loss(imgs[i:i + 1], target, 4)),
            rtol=ELEM_RTOL,
        )


# --- targets and starting images ------------------------------------------


def test_multi_style_targets_match_jax(inputs, jax_params, torch_params):
    content, styles = inputs
    ref = jax_ms.multi_style_targets(
        jax_params, _norm_j(content), [_norm_j(s) for s in styles],
        STYLE, CONTENT, precision=HIGH,
    )
    ours = multistyle.multi_style_targets(
        torch_params, _norm_t(content), [_norm_t(s) for s in styles],
        STYLE, CONTENT,
    )
    for idx in STYLE:
        want = np.asarray(ref.style_grams[idx])
        got = ours.style_grams[idx].numpy()
        assert got.shape == want.shape == (2, *want.shape[1:])
        np.testing.assert_allclose(
            got, want, rtol=TARGET_RTOL,
            atol=TARGET_RTOL * np.abs(want).max(),
        )
    for idx in CONTENT:
        want = np.asarray(ref.content_feats[idx])
        got = ours.content_feats[idx]
        assert tuple(got.shape) == want.shape == (2, 1, 32, 32, 64)
        # A broadcast of the one content's features, not a copy.
        assert got.stride(0) == 0
        np.testing.assert_allclose(
            got.numpy(), want, rtol=TARGET_RTOL,
            atol=TARGET_RTOL * np.abs(want).max(),
        )


def test_initialize_multi_inputs() -> None:
    content = _norm_t(_uniform(7, (1, 16, 16, 3)))
    gen = torch.Generator().manual_seed(0)
    drawn = multistyle.initialize_multi_inputs(content, "random", gen, 3)
    assert tuple(drawn.shape) == (3, 1, 16, 16, 3)
    assert not torch.equal(drawn[0], drawn[1])
    copied = multistyle.initialize_multi_inputs(content, "content", None, 2)
    assert torch.equal(copied[0], content)
    assert torch.equal(copied[1], content)
    copied[0].zero_()
    assert not torch.equal(copied[1], copied[0])
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        multistyle.initialize_multi_inputs(content, "random", None, 2)


def test_builder_rejects_like_jax(inputs, torch_params) -> None:
    content, styles = inputs
    targets = multistyle.multi_style_targets(
        torch_params, _norm_t(content), [_norm_t(s) for s in styles],
        STYLE, CONTENT,
    )
    kwargs = {"style_layers": STYLE, "content_layers": CONTENT}
    with pytest.raises(ValueError, match="Unknown optimizer"):
        multistyle.build_multi_style_update(
            torch_params, targets, (1, 32, 32, 3), 2, optimizer="sgd",
            **kwargs,
        )
    with pytest.raises(ValueError, match="requires a precomputed lap_target"):
        multistyle.build_multi_style_update(
            torch_params, targets, (1, 32, 32, 3), 2, lap_w=1.0, **kwargs,
        )


# --- the stacked step against JAX's ---------------------------------------

_STEP_CASES = {
    "lbfgs two-loop f32": {
        "optimizer": "lbfgs", "lbfgs_direction": "two-loop",
        "lbfgs_history_dtype": "float32",
    },
    "lbfgs two-loop bf16": {
        "optimizer": "lbfgs", "lbfgs_direction": "two-loop",
        "lbfgs_history_dtype": "bfloat16",
    },
    "lbfgs compact f32": {
        "optimizer": "lbfgs", "lbfgs_direction": "compact",
        "lbfgs_history_dtype": "float32",
    },
    "lbfgs compact bf16": {
        "optimizer": "lbfgs", "lbfgs_direction": "compact",
        "lbfgs_history_dtype": "bfloat16",
    },
    "adam": {"optimizer": "adam", "lr": 0.01, "style_w": 1e5},
}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_stacked_step_curves_match_jax(
    case, inputs, jax_params, torch_params,
) -> None:
    content, styles = inputs
    n = len(styles)
    kwargs = {
        "lr": 1.0, "style_w": 1e3, "content_w": 1.0, "tv_w": 1e-2,
        "lap_w": 10.0, "lap_pool": 4, "style_layers": STYLE,
        "content_layers": CONTENT, "style_weights": (1.0, 0.5),
        "lbfgs_history_size": 4, **_STEP_CASES[case],
    }
    content_j = _norm_j(content)
    targets_j = jax_ms.multi_style_targets(
        jax_params, content_j, [_norm_j(s) for s in styles],
        STYLE, CONTENT, precision=HIGH,
    )
    bundle_j = jax_ms.build_multi_style_update(
        create_mesh(n_style=n, n_space=1), jax_params, targets_j,
        tuple(content_j.shape), n, precision="highest",
        lap_target=jax_lap.lap_response(content_j, 4), **kwargs,
    )
    x_j = jax_ms.initialize_multi_inputs(
        content_j, "content", jax.random.key(0), n,
    )
    content_t = _norm_t(content)
    bundle_t = multistyle.build_multi_style_update(
        torch_params,
        multistyle.multi_style_targets(
            torch_params, content_t, [_norm_t(s) for s in styles],
            STYLE, CONTENT,
        ),
        tuple(content_t.shape), n,
        lap_target=lap.lap_response(content_t, 4), **kwargs,
    )
    x_t = multistyle.initialize_multi_inputs(content_t, "content", None, n)
    state_j, state_t = bundle_j.opt_state, bundle_t.opt_state
    curve_j, curve_t = [], []
    for _ in range(5):
        x_j, state_j, aux_j = bundle_j.update_fn(x_j, state_j)
        x_t, state_t, aux_t = bundle_t.update_fn(x_t, state_t)
        curve_j.append(np.asarray(aux_j.loss))
        curve_t.append(aux_t.loss.numpy())
    curve_j, curve_t = np.array(curve_j), np.array(curve_t)
    assert curve_t.shape == (5, n)
    assert np.all(curve_t[-1] < curve_t[0])
    np.testing.assert_allclose(curve_t, curve_j, rtol=CURVE_RTOL)


# --- the batched optimizers against the single ones -----------------------


@pytest.mark.parametrize(
    "case", ["lbfgs two-loop bf16", "lbfgs compact f32", "adam"],
)
def test_batched_step_at_one_style_is_the_single_step(
    case, inputs, torch_params,
) -> None:
    content, styles = inputs
    content_t = _norm_t(content)
    style_t = _norm_t(styles[1])
    kwargs = {
        "lr": 1.0, "style_w": 1e3, "content_w": 1.0, "tv_w": 1e-2,
        "lap_w": 10.0, "lap_pool": 4, "style_layers": STYLE,
        "content_layers": CONTENT, "style_weights": (1.0, 0.5),
        "lbfgs_history_size": 4,
        "lap_target": lap.lap_response(content_t, 4),
        **_STEP_CASES[case],
    }
    single = build_update_step(
        torch_params,
        compute_targets(torch_params, style_t, content_t, STYLE, CONTENT),
        tuple(content_t.shape), **kwargs,
    )
    batched = multistyle.build_multi_style_update(
        torch_params,
        multistyle.multi_style_targets(
            torch_params, content_t, [style_t], STYLE, CONTENT,
        ),
        tuple(content_t.shape), 1, **kwargs,
    )
    x_s, st_s = content_t.clone(), single.opt_state
    x_b = multistyle.initialize_multi_inputs(content_t, "content", None, 1)
    st_b = batched.opt_state
    for _ in range(3):
        x_s, st_s, aux_s = single.update_fn(x_s, st_s)
        x_b, st_b, aux_b = batched.update_fn(x_b, st_b)
        assert tuple(aux_b.loss.shape) == (1,)
        for field in ("loss", "style_score", "content_score"):
            np.testing.assert_allclose(
                float(getattr(aux_b, field)[0]),
                float(getattr(aux_s, field)), rtol=SAME_RTOL,
            )
        np.testing.assert_allclose(
            x_b[0].numpy(), x_s.numpy(), rtol=SAME_RTOL,
            atol=SAME_RTOL * float(x_s.abs().max()),
        )


def _quadratic(a: torch.Tensor, b: torch.Tensor):
    """``vag`` of ``0.5 |a x - b|^2`` for stacked ``(S, n)`` problems."""

    def vag(x: torch.Tensor):
        r = torch.einsum("sij,sj->si", a, x) - b
        loss = 0.5 * (r * r).sum(dim=1)
        grad = torch.einsum("sij,si->sj", a, r)
        return (loss, (loss, torch.zeros_like(loss))), grad

    return vag


@pytest.mark.parametrize("direction", ["two-loop", "compact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_style_keeps_its_own_ring(direction, dtype) -> None:
    """A style that is done at once keeps its ring while another runs.

    Style 0 starts at its optimum (gradient 0: ``done`` before the
    first iteration); style 1 runs up to 3 inner iterations a step.
    Each must end where its own single run ends.
    """
    rng = np.random.default_rng(8)
    n, m = 12, 3
    a = torch.from_numpy(
        (rng.normal(size=(2, n, n)) * 0.3 + 2 * np.eye(n)).astype(np.float32),
    )
    x_star = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    b = torch.stack([a[0] @ x_star, torch.from_numpy(
        rng.normal(size=(n,)).astype(np.float32),
    )])
    x0 = torch.stack([x_star, torch.zeros(n)])
    step = {"max_iter": 3, "max_eval": 4, "direction_method": direction}
    xb = x0.clone()
    st_b = optimizers.lbfgs_init_batched(2, n, m, "cpu", dtype)
    vag_b = _quadratic(a, b)
    singles = []
    for s in range(2):
        vag_s = _quadratic(a[s:s + 1], b[s:s + 1])

        def vag_one(x, _vag=vag_s):
            (loss, (sc, cc)), grad = _vag(x[None])
            return (loss[0], (sc[0], cc[0])), grad[0]

        singles.append([
            vag_one, x0[s].clone(), optimizers.lbfgs_init(n, m, "cpu", dtype),
        ])
    for _ in range(4):
        xb, st_b, aux_b = optimizers.lbfgs_step_batched(
            vag_b, xb, st_b, 0.5, **step,
        )
        for s, entry in enumerate(singles):
            vag_one, x_s, st_s = entry
            x_s, st_s, aux_s = optimizers.lbfgs_step(
                vag_one, x_s, st_s, 0.5, **step,
            )
            entry[1], entry[2] = x_s, st_s
            assert int(aux_b.n_evals[s]) == int(aux_s.n_evals)
    for s, (_, x_s, st_s) in enumerate(singles):
        np.testing.assert_allclose(
            xb[s].numpy(), x_s.numpy(), rtol=SAME_RTOL, atol=SAME_RTOL,
        )
        for field in ("hist_pos", "hist_len", "n_total_iters", "func_evals"):
            assert int(getattr(st_b, field)[s]) == int(getattr(st_s, field))
    # The done style never moved: ring empty, image at its optimum.
    assert int(st_b.hist_len[0]) == int(st_b.hist_pos[0]) == 0
    assert torch.equal(xb[0], x_star)
    assert int(st_b.hist_len[1]) == m


@pytest.mark.parametrize(
    "case", ["lbfgs compact bf16", "lbfgs two-loop f32", "adam"],
)
def test_each_style_is_its_single_run(
    case, inputs, torch_params, monkeypatch,
) -> None:
    """Bit for bit, given a conv that sums each image as alone.

    On the card the conv kernel's plan does that (``conv_plan`` picks
    its split per image); on the CPU ``F.conv2d`` may not, so the
    plain conv runs image by image here.
    """
    plain = conv3x3.conv3x3_plain

    def per_image(x, w9, b, relu, mask=None):
        return torch.cat([
            plain(x[i:i + 1], w9, b, relu,
                  None if mask is None else mask[i:i + 1])
            for i in range(x.shape[0])
        ])

    monkeypatch.setattr(conv3x3, "conv3x3_plain", per_image)
    content, styles = inputs
    content_t = _norm_t(content)
    styles_t = [_norm_t(s) for s in styles]
    kwargs = {
        "lr": 1.0, "style_w": 1e3, "content_w": 1.0, "tv_w": 1e-2,
        "lap_w": 10.0, "lap_pool": 4, "style_layers": STYLE,
        "content_layers": CONTENT, "style_weights": (1.0, 0.5),
        "lbfgs_history_size": 4,
        "lap_target": lap.lap_response(content_t, 4),
        **_STEP_CASES[case],
    }
    batched = multistyle.build_multi_style_update(
        torch_params,
        multistyle.multi_style_targets(
            torch_params, content_t, styles_t, STYLE, CONTENT,
        ),
        tuple(content_t.shape), len(styles_t), **kwargs,
    )
    x_b = multistyle.initialize_multi_inputs(
        content_t, "content", None, len(styles_t),
    )
    st_b = batched.opt_state
    losses = []
    for _ in range(6):
        x_b, st_b, aux_b = batched.update_fn(x_b, st_b)
        losses.append(aux_b.loss)
    for i, style_t in enumerate(styles_t):
        single = build_update_step(
            torch_params,
            compute_targets(torch_params, style_t, content_t, STYLE, CONTENT),
            tuple(content_t.shape), **kwargs,
        )
        x_s, st_s = content_t.clone(), single.opt_state
        for step in range(6):
            x_s, st_s, aux_s = single.update_fn(x_s, st_s)
            np.testing.assert_allclose(
                float(losses[step][i]), float(aux_s.loss), rtol=SAME_RTOL,
            )
        assert torch.equal(x_b[i], x_s)


# --- the batched warm start -----------------------------------------------


@pytest.mark.parametrize(("size", "runs"), [(1024, True), (512, False)])
def test_batch_takes_the_auto_warm_start(monkeypatch, size, runs) -> None:
    steps = 20
    seen = {}

    def fake_multi_coarse_init(params, content_img, style_imgs, config,
                               generator, **block):
        # One process holds the whole batch: its block is all of it.
        assert block == {"first": 0, "n_drawn": len(style_imgs)}
        opt = config.optimization
        seen["coarse_steps"] = opt.coarse_steps
        seen["schedule"] = coarse.plan_pyramid(
            size, size, opt.coarse_steps, opt.pyramid_levels,
        )
        seen["shapes"] = [tuple(s.shape) for s in style_imgs]
        return torch.full((len(style_imgs), 1, size, size, 3), 0.25)

    monkeypatch.setattr(main, "multi_coarse_init", fake_multi_coarse_init)
    # One conv layer keeps the 1 MP targets cheap; Adam keeps the
    # optimizer state at two image-sized moments per style.
    params = {0: vgg19.init_random_params(0, "cpu")[0]}
    config = StyleTransferConfig(
        optimization=OptimizationConfig(
            steps=steps, optimizer="adam", style_layers=[0],
            content_layers=[0], init_method="content",
        ),
        hardware=HardwareConfig(device="cpu"),
    )
    content = _uniform(50, (1, size, size, 3))
    styles = [_uniform(51, (1, 64, 64, 3)), _uniform(52, (1, 48, 80, 3))]
    _, start = main.prepare_multi_style(
        content, styles, config, params=params,
    )
    want = jax_coarse.resolve_coarse_steps(-1, size, size, steps)
    assert config.optimization.coarse_steps == want
    assert tuple(start.shape) == (2, 1, size, size, 3)
    if runs:
        assert want == steps // 5
        assert seen["coarse_steps"] == want
        assert seen["schedule"] == jax_coarse.plan_pyramid(
            size, size, want, 2,
        ) == [(size // 2, size // 2, want)]
        assert seen["shapes"] == [(1, 64, 64, 3), (1, 48, 80, 3)]
        assert bool((start == 0.25).all())
    else:
        assert want == 0
        assert not seen
        for img in start:
            assert torch.equal(img, _norm_t(content))


def test_multi_coarse_init_matches_jax(jax_params, torch_params) -> None:
    """Two levels (32 and 64 px of a 128 px content), two styles.

    ``lap_pool=16`` leaves the 32 px level a 2x2 pooled image, so the
    Laplacian term starts at the 64 px level in both packages.
    """
    content = _uniform(40, (1, 128, 128, 3))
    styles = [_uniform(41, (1, 128, 128, 3)), _uniform(42, (1, 96, 112, 3))]
    fields = {
        "steps": 3, "optimizer": "adam", "lr": 0.1, "style_layers": [0, 5],
        "content_layers": [2], "init_method": "content", "seed": 0,
        "allow_random_weights": True, "tv_w": 1e-2, "lap_w": 1e2,
        "lap_pool": 16, "style_layer_weights": [1.0, 0.5],
        "coarse_steps": 3, "pyramid_levels": 3,
    }
    jax_cfg = JaxConfig.model_validate({
        "optimization": fields, "hardware": {"device": "cpu"},
    })
    warm_j = jax_main._multi_initial_images(  # noqa: SLF001
        create_mesh(n_style=2, n_space=1), jax_params, _norm_j(content),
        [_norm_j(s) for s in styles], jax_cfg, jax.random.key(0), 2,
        "xla", 1,
    )
    config = StyleTransferConfig(
        optimization=OptimizationConfig(**fields),
        hardware=HardwareConfig(device="cpu"),
    )
    warm = coarse.multi_coarse_init(
        torch_params, _norm_t(content), [_norm_t(s) for s in styles],
        config, None,
    )
    assert tuple(warm.shape) == (2, 1, 128, 128, 3)
    diff = np.abs(warm.numpy() - np.asarray(warm_j))
    assert diff.mean() <= WARM_MEAN_ATOL
    std = np.asarray(IMAGENET_STD, dtype=np.float32)
    assert (diff * std).max() * 255 <= WARM_LEVELS
