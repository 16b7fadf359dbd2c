"""The port's whole objective vs the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and
its counterpart in the port. Tolerances, each set from float32 with
sums in different orders:

- elementwise ops and their gradients (``tv_loss``, ``lap_loss``,
  ``luminance_transfer``, through ``torch.autograd`` against
  ``jax.grad``): 1e-6 relative;
- ``match_color_distribution``: bit-equal (both are float64 numpy);
- per-layer style weights and blended targets (through the VGG convs at
  taps [0, 5]/[2], 32x32): 1e-5 relative, gradients 1e-4 of their
  largest magnitude, as ``tests/test_torch_slice.py`` holds the loss;
- ``adam_step``: 1e-6 over 10 steps on a quadratic, and a 3-step VGG
  loss curve within 1e-3 relative (the curve gate of the JAX package's
  ``ops/precision.py``);
- VGG16 seeded weights bit-equal, its layer table and tap remap equal;
- config defaults and the bounds of every new field: equal values and
  the same rejections.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_visualizer_tpu import image_io as jax_image_io
from style_transfer_visualizer_tpu.config import (
    OptimizationConfig as JaxOptimizationConfig,
)
from style_transfer_visualizer_tpu.engine import optimizers as jax_opt
from style_transfer_visualizer_tpu.engine.step import (
    build_update_step as jax_build_update_step,
)
from style_transfer_visualizer_tpu.models import arch as jax_arch
from style_transfer_visualizer_tpu.models import features as jax_features
from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.ops import color as jax_color
from style_transfer_visualizer_tpu.ops import lap as jax_lap
from style_transfer_visualizer_tpu.ops import tv as jax_tv
from style_transfer_visualizer_tpu_torch import image_io
from style_transfer_visualizer_tpu_torch.config import OptimizationConfig
from style_transfer_visualizer_tpu_torch.engine import optimizers
from style_transfer_visualizer_tpu_torch.engine.step import build_update_step
from style_transfer_visualizer_tpu_torch.models import arch, features, vgg19
from style_transfer_visualizer_tpu_torch.ops import color, lap, tv

ELEM_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CURVE_RTOL = 1e-3
STYLE, CONTENT = (0, 5), (2,)


def _rng_image(seed: int, shape=(1, 32, 32, 3), low=0.0, high=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=shape).astype(np.float32)


def _grad_pair(fn_t, fn_j, *arrays):
    """Value and gradient of a scalar function in both packages."""
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn_t(*ts)
    grads_t = torch.autograd.grad(out, ts)
    val_j, grads_j = jax.value_and_grad(
        fn_j, argnums=tuple(range(len(arrays))),
    )(*(jnp.asarray(a) for a in arrays))
    return (
        float(out.detach()), [g.numpy() for g in grads_t],
        float(val_j), [np.asarray(g) for g in grads_j],
    )


def _assert_grads(ours, ref, rtol) -> None:
    for g_t, g_j in zip(ours, ref, strict=True):
        np.testing.assert_allclose(
            g_t, g_j, rtol=rtol, atol=rtol * np.abs(g_j).max(),
        )


# --- TV and Laplacian terms ---------------------------------------------


@pytest.mark.parametrize("shape", [(1, 32, 32, 3), (1, 17, 40, 3)])
def test_tv_loss_and_grad_match_jax(shape) -> None:
    x = _rng_image(1, shape, -2.0, 2.5)
    v_t, g_t, v_j, g_j = _grad_pair(tv.tv_loss, jax_tv.tv_loss, x)
    np.testing.assert_allclose(v_t, v_j, rtol=ELEM_RTOL)
    _assert_grads(g_t, g_j, ELEM_RTOL)


@pytest.mark.parametrize("pool", [1, 2, 4])
def test_lap_loss_and_grad_match_jax(pool) -> None:
    x = _rng_image(2, (1, 38, 45, 3), -2.0, 2.5)
    content = _rng_image(3, (1, 38, 45, 3), -2.0, 2.5)
    target_j = jax_lap.lap_response(jnp.asarray(content), pool)
    target_t = lap.lap_response(torch.from_numpy(content), pool)
    np.testing.assert_allclose(
        target_t.numpy(), np.asarray(target_j), rtol=ELEM_RTOL,
        atol=ELEM_RTOL * float(np.abs(np.asarray(target_j)).max()),
    )
    v_t, g_t, v_j, g_j = _grad_pair(
        lambda a: lap.lap_loss(a, target_t, pool),
        lambda a: jax_lap.lap_loss(a, target_j, pool),
        x,
    )
    np.testing.assert_allclose(v_t, v_j, rtol=ELEM_RTOL)
    _assert_grads(g_t, g_j, ELEM_RTOL)


def test_avg_pool_crops_like_jax() -> None:
    x = _rng_image(4, (1, 13, 10, 3))
    for pool in (1, 3, 4):
        np.testing.assert_allclose(
            lap._avg_pool(torch.from_numpy(x), pool).numpy(),
            np.asarray(jax_lap._avg_pool(jnp.asarray(x), pool)),
            rtol=ELEM_RTOL,
        )


def test_lap_response_rejects_a_small_pooled_image() -> None:
    x = _rng_image(5, (1, 11, 64, 3))
    with pytest.raises(ValueError, match="lower --lap-pool"):
        jax_lap.lap_response(jnp.asarray(x), 4)
    with pytest.raises(ValueError, match="lower --lap-pool"):
        lap.lap_response(torch.from_numpy(x), 4)


# --- Color preservation --------------------------------------------------


def test_yiq_matrices_equal_jax() -> None:
    to_yiq, to_rgb = color.yiq_matrices(torch.device("cpu"))
    np.testing.assert_array_equal(
        to_yiq.numpy(), np.asarray(jax_color.RGB_TO_YIQ),
    )
    np.testing.assert_array_equal(
        to_rgb.numpy(), np.asarray(jax_color.YIQ_TO_RGB),
    )
    rgb = torch.from_numpy(_rng_image(6))
    back = color.yiq_to_rgb(color.rgb_to_yiq(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-6)


@pytest.mark.parametrize(
    ("stylized_shape", "content_shape"),
    [((1, 24, 20, 3), (1, 24, 20, 3)), ((2, 1, 24, 20, 3), (1, 24, 20, 3))],
)
def test_luminance_transfer_and_grad_match_jax(
    stylized_shape, content_shape,
) -> None:
    stylized = _rng_image(7, stylized_shape)
    content = _rng_image(8, content_shape)
    ours = color.luminance_transfer(
        torch.from_numpy(stylized), torch.from_numpy(content),
    )
    ref = np.asarray(
        jax_color.luminance_transfer(
            jnp.asarray(stylized), jnp.asarray(content),
        ),
    )
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=ELEM_RTOL, atol=1e-7)
    # The gradient of a weighted sum is elementwise; the sum itself
    # cancels, so its value is not compared.
    weights = _rng_image(9, ref.shape, -1.0, 1.0)
    _, g_t, _, g_j = _grad_pair(
        lambda s, c: (
            color.luminance_transfer(s, c) * torch.from_numpy(weights)
        ).sum(),
        lambda s, c: (
            jax_color.luminance_transfer(s, c) * jnp.asarray(weights)
        ).sum(),
        stylized, content,
    )
    _assert_grads(g_t, g_j, ELEM_RTOL)


def test_maybe_restore_color_passes_through_without_a_source() -> None:
    img = torch.from_numpy(_rng_image(10))
    assert color.maybe_restore_color(img, None) is img
    content = torch.from_numpy(_rng_image(11))
    torch.testing.assert_close(
        color.maybe_restore_color(img, content),
        color.luminance_transfer(img, content),
    )


@pytest.mark.parametrize("palette", ["noise", "gray"])
def test_match_color_distribution_bit_equal(palette) -> None:
    style = _rng_image(12, (1, 40, 30, 3))
    if palette == "gray":
        # A rank-deficient covariance takes the eigenvalue floor.
        style = np.repeat(style[..., :1], 3, axis=-1)
    content = _rng_image(13, (1, 32, 32, 3)) * np.float32([1.0, 0.6, 0.3])
    ours = color.match_color_distribution(style, content)
    ref = jax_color.match_color_distribution(style, content)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_load_style_image_to_array_matches_jax(tmp_path) -> None:
    path = tmp_path / "style.png"
    rng = np.random.default_rng(14)
    Image.fromarray(
        rng.integers(0, 256, (80, 64, 3), dtype=np.uint8),
    ).save(path)
    content = _rng_image(15, (1, 64, 64, 3))
    for match_to in (None, content):
        ours = image_io.load_style_image_to_array(
            path, "cpu", normalize=True, match_to=match_to,
        )
        ref = jax_image_io.load_style_image_to_array(
            path, normalize=True, match_to=match_to,
        )
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(ref), rtol=ELEM_RTOL, atol=1e-6,
        )


def test_uint8_frame_is_recolored() -> None:
    stylized = torch.from_numpy(_rng_image(16, (1, 16, 16, 3)))
    content = torch.from_numpy(_rng_image(17, (1, 16, 16, 3)))
    ours = image_io.array_to_uint8_frame(
        stylized, normalize=False, chroma_source=content,
    )
    ref = jax_image_io.array_to_uint8_frame(
        jnp.asarray(stylized.numpy()), normalize=False,
        chroma_source=jnp.asarray(content.numpy()),
    )
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1


# --- Style weights and blended targets ----------------------------------


@pytest.fixture(scope="module")
def vgg_pair():
    """Seeded VGG19 weights in both packages, and 32x32 inputs."""
    params_j = jax_vgg19.init_random_params(jax.random.key(0))
    params_t = vgg19.init_random_params(0, "cpu")
    content, style1, style2, init = (
        _rng_image(20 + i) for i in range(4)
    )
    return params_j, params_t, (content, style1, style2, init)


def _targets(params_j, params_t, style, content, content_layers=CONTENT):
    norm_j = jax_image_io.normalize_image
    ref = jax_features.compute_targets(
        params_j, norm_j(jnp.asarray(style)), norm_j(jnp.asarray(content)),
        STYLE, content_layers,
    )
    ours = features.compute_targets(
        params_t,
        image_io.host_array_to_device(style, "cpu", normalize=True),
        image_io.host_array_to_device(content, "cpu", normalize=True),
        STYLE, content_layers,
    )
    return ref, ours


def _assert_targets(ours, ref) -> None:
    assert sorted(ours.style_grams) == sorted(ref.style_grams)
    assert sorted(ours.content_feats) == sorted(ref.content_feats)
    for mine, theirs in (
        (ours.style_grams, ref.style_grams),
        (ours.content_feats, ref.content_feats),
    ):
        for idx, value in theirs.items():
            value = np.asarray(value)
            np.testing.assert_allclose(
                mine[idx].numpy(), value, rtol=LOSS_RTOL,
                atol=LOSS_RTOL * np.abs(value).max(),
            )


@pytest.mark.parametrize("weights", [None, (1.0, 0.25), (0.0, 2.0)])
def test_style_weights_loss_and_grad_match_jax(vgg_pair, weights) -> None:
    params_j, params_t, (content, style, _, init) = vgg_pair
    ref_t, ours_t = _targets(params_j, params_t, style, content)
    v_t, g_t, v_j, g_j = _grad_pair(
        lambda x: features.total_loss(
            params_t, x, ours_t, 1e5, 1.0, STYLE, CONTENT, weights,
        )[0],
        lambda x: jax_features.total_loss(
            params_j, x, ref_t, 1e5, 1.0, STYLE, CONTENT,
            style_weights=weights,
        )[0],
        init,
    )
    np.testing.assert_allclose(v_t, v_j, rtol=LOSS_RTOL)
    err = np.abs(g_t[0] - g_j[0]).max()
    assert err <= GRAD_RTOL * np.abs(g_j[0]).max()


def test_unit_style_weights_are_bit_equal_to_none(vgg_pair) -> None:
    params_j, params_t, (content, style, _, init) = vgg_pair
    _, targets = _targets(params_j, params_t, style, content)
    x = torch.from_numpy(init)
    plain = features.total_loss(params_t, x, targets, 1e5, 1.0, STYLE, CONTENT)
    unit = features.total_loss(
        params_t, x, targets, 1e5, 1.0, STYLE, CONTENT, (1.0, 1.0),
    )
    assert torch.equal(plain[0], unit[0])


def test_style_weights_length_is_checked_like_jax() -> None:
    with pytest.raises(ValueError, match="style_weights has 1 entries"):
        jax_features._resolve_style_weights((1.0,), STYLE)
    with pytest.raises(ValueError, match="style_weights has 1 entries"):
        features._resolve_style_weights((1.0,), STYLE)


def test_blended_targets_match_jax(vgg_pair) -> None:
    params_j, params_t, (content, style1, style2, _) = vgg_pair
    first_j, first_t = _targets(params_j, params_t, style1, content)
    extra_j, extra_t = _targets(params_j, params_t, style2, content, ())
    assert extra_t.content_feats == {}
    weights = [0.7, 0.3]
    _assert_targets(
        features.blend_targets([first_t, extra_t], weights),
        jax_features.blend_targets([first_j, extra_j], weights),
    )
    seen = []

    def one_targets(img, layers):
        seen.append(layers)
        return first_t if layers else extra_t

    blended = features.targets_maybe_blended(
        one_targets, None, CONTENT, [(1, 0.7), (2, 0.3)],
    )
    assert seen == [CONTENT, ()]
    assert blended.content_feats is first_t.content_feats
    assert features.targets_maybe_blended(
        one_targets, None, CONTENT, None,
    ) is first_t


def test_blend_targets_needs_one_weight_per_entry(vgg_pair) -> None:
    params_j, params_t, (content, style, _, _) = vgg_pair
    ref, ours = _targets(params_j, params_t, style, content)
    with pytest.raises(ValueError, match="one weight per Targets"):
        jax_features.blend_targets([ref], [0.5, 0.5])
    with pytest.raises(ValueError, match="one weight per Targets"):
        features.blend_targets([ours], [0.5, 0.5])


# --- Adam ----------------------------------------------------------------


def test_adam_on_quadratic_matches_jax() -> None:
    n = 24
    rng = np.random.default_rng(30)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = ((q * np.geomspace(0.05, 5.0, n)) @ q.T).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    x0 = rng.normal(size=(1, 2, 4, 3)).astype(np.float32)

    def vag_j(x):
        flat = x.reshape(n)
        loss = 0.5 * flat @ (jnp.asarray(a) @ flat) - jnp.asarray(b) @ flat
        grad = (jnp.asarray(a) @ flat - jnp.asarray(b)).reshape(x.shape)
        return (loss, (loss, jnp.zeros(()))), grad

    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def vag_t(x):
        flat = x.reshape(n)
        loss = 0.5 * flat @ (at @ flat) - bt @ flat
        return (loss, (loss, torch.zeros(()))), (at @ flat - bt).reshape(
            x.shape,
        )

    step_j = jax.jit(lambda x, st: jax_opt.adam_step(vag_j, x, st, 0.1))
    x_j, st_j = jnp.asarray(x0), jax_opt.adam_init(x0.shape)
    x_t = torch.from_numpy(x0.copy())
    st_t = optimizers.adam_init(x0.shape, "cpu")
    assert st_t.count.dtype == torch.int32
    for _ in range(10):
        x_j, st_j, aux_j = step_j(x_j, st_j)
        x_t, st_t, aux_t = optimizers.adam_step(vag_t, x_t, st_t, 0.1)
        ref = np.asarray(x_j)
        np.testing.assert_allclose(
            x_t.numpy(), ref, rtol=ELEM_RTOL,
            atol=ELEM_RTOL * np.abs(ref).max(),
        )
        assert int(aux_t.n_evals) == int(aux_j.n_evals) == 1
    assert int(st_t.count) == int(st_j.count) == 10
    np.testing.assert_allclose(
        st_t.nu.numpy(), np.asarray(st_j.nu), rtol=ELEM_RTOL,
    )


def _objective_kwargs(content, lap_target):
    return {
        "lr": 0.1, "style_w": 1e5, "content_w": 1.0, "tv_w": 1e-2,
        "lap_w": 1e2, "lap_pool": 2, "lap_target": lap_target,
        "style_layers": STYLE, "content_layers": CONTENT,
        "style_weights": (1.0, 0.5),
    }


def test_adam_vgg_curve_with_every_term_matches_jax(vgg_pair) -> None:
    params_j, params_t, (content, style, _, init) = vgg_pair
    targets_j, targets_t = _targets(params_j, params_t, style, content)
    content_n = image_io.host_array_to_device(content, "cpu", normalize=True)
    bundle_j = jax_build_update_step(
        params_j, targets_j, init.shape, optimizer="adam",
        precision="highest",
        **_objective_kwargs(
            content,
            jax_lap.lap_response(jnp.asarray(content_n.numpy()), 2),
        ),
    )
    bundle_t = build_update_step(
        params_t, targets_t, init.shape, optimizer="adam",
        **_objective_kwargs(content, lap.lap_response(content_n, 2)),
    )
    assert isinstance(bundle_t.opt_state, optimizers.AdamState)
    img_j, st_j = jnp.asarray(init), bundle_j.opt_state
    img_t, st_t = torch.from_numpy(init.copy()), bundle_t.opt_state
    curve_j, curve_t = [], []
    for _ in range(3):
        img_j, st_j, aux_j = bundle_j.update_fn(img_j, st_j)
        img_t, st_t, aux_t = bundle_t.update_fn(img_t, st_t)
        curve_j.append(float(aux_j.loss))
        curve_t.append(float(aux_t.loss))
    np.testing.assert_allclose(curve_t, curve_j, rtol=CURVE_RTOL)
    assert curve_t[-1] < curve_t[0]
    # The chunked path runs the same steps.
    _, _, stacked = bundle_t.chunked_update_fn(
        torch.from_numpy(init.copy()),
        optimizers.adam_init(init.shape, "cpu"), 3,
    )
    np.testing.assert_allclose(stacked.loss.numpy(), curve_t, rtol=1e-6)


@pytest.mark.parametrize(
    ("kwargs", "match"),
    [
        ({"optimizer": "sgd"}, "Unknown optimizer"),
        ({"optimizer": "adam", "lap_w": 1.0}, "requires a precomputed"),
    ],
)
def test_build_update_step_rejects_like_jax(vgg_pair, kwargs, match) -> None:
    params_j, params_t, (content, style, _, init) = vgg_pair
    targets_j, targets_t = _targets(params_j, params_t, style, content)
    common = {
        "lr": 1.0, "style_w": 1.0, "content_w": 1.0,
        "style_layers": STYLE, "content_layers": CONTENT,
    }
    with pytest.raises(ValueError, match=match):
        jax_build_update_step(params_j, targets_j, init.shape, **common,
                              **kwargs)
    with pytest.raises(ValueError, match=match):
        build_update_step(params_t, targets_t, init.shape, **common, **kwargs)


# --- VGG16 ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_vgg16_seeded_weights_bit_equal(seed) -> None:
    ref = jax_vgg19.init_random_params(
        jax.random.key(seed), arch=jax_arch.VGG16,
    )
    ours = vgg19.params_to_numpy(
        vgg19.init_random_params(seed, "cpu", arch.VGG16),
    )
    assert sorted(ours) == sorted(ref) == list(arch.VGG16.conv_indices)
    for idx, layer in ref.items():
        np.testing.assert_array_equal(ours[idx]["w"], np.asarray(layer["w"]))
        np.testing.assert_array_equal(ours[idx]["b"], np.asarray(layer["b"]))


def test_pretrained_archive_is_picked_by_architecture(tmp_path) -> None:
    host = vgg19.init_random_host_params(7, arch.VGG16)
    np.savez(
        tmp_path / arch.VGG16.cache_filename,
        **{f"w{i}": layer["w"] for i, layer in host.items()},
        **{f"b{i}": layer["b"] for i, layer in host.items()},
    )
    loaded = vgg19.params_to_numpy(
        vgg19.load_pretrained_params(
            "cpu", arch=arch.VGG16, cache_dir=tmp_path,
        ),
    )
    for idx, layer in host.items():
        np.testing.assert_array_equal(loaded[idx]["w"], layer["w"])
    with pytest.raises(FileNotFoundError, match="VGG19 weights not found"):
        vgg19.load_pretrained_params("cpu", cache_dir=tmp_path)


@pytest.mark.parametrize("name", ["vgg19", "vgg16"])
def test_architecture_registry_matches_jax(name) -> None:
    ours, ref = arch.get_architecture(name), jax_arch.get_architecture(name)
    assert ours.layer_table == ref.layer_table
    assert ours.conv_indices == ref.conv_indices
    assert ours.default_style_layers == ref.default_style_layers
    assert ours.default_content_layers == ref.default_content_layers
    assert ours.cache_filename == ref.cache_filename
    params = vgg19.init_random_params(0, "cpu", ours)
    assert arch.layer_table_from_params(params) == ref.layer_table


def test_unknown_architecture_raises_like_jax() -> None:
    with pytest.raises(ValueError, match="known: vgg16, vgg19"):
        jax_arch.get_architecture("vgg11")
    with pytest.raises(ValueError, match="known: vgg16, vgg19"):
        arch.get_architecture("vgg11")


@pytest.mark.parametrize(
    "fields",
    [
        {"model": "vgg16"},
        {"model": "vgg16", "style_layers": [0, 5]},
        {"model": "vgg16", "content_layers": [12]},
        {"model": "vgg16", "style_layer_weights": [1, 1, 0.5, 0.25, 0.25]},
        {"model": "vgg19"},
    ],
)
def test_tap_remap_matches_jax(fields) -> None:
    ours = OptimizationConfig(**fields)
    ref = JaxOptimizationConfig.model_validate(fields)
    assert ours.style_layers == ref.style_layers
    assert ours.content_layers == ref.content_layers
    assert ours.style_weights_tuple() == ref.style_weights_tuple()


# --- Config defaults and bounds ------------------------------------------

_NEW_FIELDS = (
    "optimizer", "tv_w", "lap_w", "lap_pool", "preserve_color",
    "style_layer_weights", "model", "coarse_steps", "pyramid_levels",
)


def test_new_config_defaults_equal_jax() -> None:
    ours = OptimizationConfig()
    ref = JaxOptimizationConfig.model_validate({})
    for name in _NEW_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.style_weights_tuple() is None


@pytest.mark.parametrize(
    "fields",
    [
        {"tv_w": -0.1},
        {"lap_w": -1.0},
        {"lap_pool": 0},
        {"preserve_color": "hue"},
        {"model": "vgg11"},
        {"optimizer": "sgd"},
        {"coarse_steps": -2},
        {"pyramid_levels": 1},
        {"pyramid_levels": 7},
        {"style_layer_weights": [1.0, 1.0]},
        {"style_layer_weights": [1.0, 1.0, -1.0, 1.0, 1.0]},
        {"style_layer_weights": [0.0, 0.0, 0.0, 0.0, 0.0]},
        {"model": "vgg16", "style_layer_weights": [1.0, 1.0, 1.0]},
    ],
)
def test_new_config_bounds_reject_like_jax(fields) -> None:
    with pytest.raises(ValueError):  # noqa: PT011 - pydantic's subclass
        JaxOptimizationConfig.model_validate(fields)
    with pytest.raises(ValueError):  # noqa: PT011
        OptimizationConfig(**fields)


@pytest.mark.parametrize(
    "fields",
    [
        {"tv_w": 0.0, "lap_w": 0.0, "lap_pool": 1},
        {"coarse_steps": -1, "pyramid_levels": 2},
        {"coarse_steps": 0, "pyramid_levels": 6},
        {"style_layer_weights": []} | {"style_layers": []},
        {"preserve_color": "match", "optimizer": "adam", "model": "vgg16"},
    ],
)
def test_new_config_bounds_accept_like_jax(fields) -> None:
    ref = JaxOptimizationConfig.model_validate(fields)
    ours = OptimizationConfig(**fields)
    for name in (*_NEW_FIELDS, "style_layers", "content_layers"):
        assert getattr(ours, name) == getattr(ref, name), name


def test_validate_checks_fields_set_after_construction() -> None:
    cfg = OptimizationConfig()
    cfg.style_layer_weights = [1.0]
    with pytest.raises(ValueError, match="1 entries for 5 style layers"):
        cfg.validate()
