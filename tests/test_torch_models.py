"""The port's weights, pooling and feature taps vs the JAX package.

Same seeds and same numpy inputs on both sides. Weights must match bit
for bit; pooled values and their tie-routing gradients exactly; feature
taps to 1e-5 relative to each tap's largest magnitude (float32 convs
summed in different orders, compounded over up to 13 layers).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.models import vgg19 as jax_vgg19
from style_transfer_visualizer_tpu.models.features import (
    extract_features as jax_extract,
)
from style_transfer_visualizer_tpu.ops.pool import maxpool_2x2 as jax_pool
from style_transfer_visualizer_tpu_torch.models import arch, vgg19
from style_transfer_visualizer_tpu_torch.models.features import (
    extract_features,
)
from style_transfer_visualizer_tpu_torch.ops.pool import maxpool_2x2, relu

TAP_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax_vgg19.init_random_params(jax.random.key(3))


@pytest.mark.parametrize("seed", [0, 3])
def test_init_random_params_bit_equal(seed) -> None:
    ref = jax_vgg19.init_random_params(jax.random.key(seed))
    ours = vgg19.params_to_numpy(vgg19.init_random_params(seed, "cpu"))
    assert sorted(ours) == sorted(ref) == list(arch.VGG19.conv_indices)
    for idx, layer in ref.items():
        np.testing.assert_array_equal(ours[idx]["w"], np.asarray(layer["w"]))
        np.testing.assert_array_equal(ours[idx]["b"], np.asarray(layer["b"]))


def test_params_from_numpy_round_trips_and_flips(jax_params) -> None:
    params = vgg19.params_from_numpy(jax_params, "cpu")
    back = vgg19.params_to_numpy(params)
    for idx, layer in jax_params.items():
        np.testing.assert_array_equal(back[idx]["w"], np.asarray(layer["w"]))
    from style_transfer_visualizer_tpu.ops.frozen_conv import flip_kernel

    w = jax_params[5]["w"]
    ref_flip = np.asarray(flip_kernel(w)).reshape(9, w.shape[3], w.shape[2])
    np.testing.assert_array_equal(params[5]["w9_flip"].numpy(), ref_flip)


def test_layer_table_matches_vgg19(jax_params) -> None:
    params = vgg19.params_from_numpy(jax_params, "cpu")
    assert arch.layer_table_from_params(params) == arch.VGG19.layer_table


def test_load_params_npz_reads_the_jax_layout(jax_params, tmp_path) -> None:
    path = tmp_path / "w.npz"
    jax_vgg19.save_params_npz(jax_params, path)
    params = vgg19.load_params_npz(path, "cpu")
    back = vgg19.params_to_numpy(params)
    for idx, layer in jax_params.items():
        np.testing.assert_array_equal(back[idx]["w"], np.asarray(layer["w"]))


def _tied_map(seed: int, shape) -> np.ndarray:
    # Small integer levels make ties inside 2x2 windows common.
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 8, 8, 4), (2, 7, 9, 3)])
def test_maxpool_tie_rule_matches_jax(shape) -> None:
    x = _tied_map(0, shape)
    out_shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    g = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)

    ref_out, vjp = jax.vjp(jax_pool, jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = maxpool_2x2(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_dx))


def test_relu_gradient_is_zero_at_zero() -> None:
    xt = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    relu(xt).sum().backward()
    assert xt.grad.tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize(
    "taps", [(0, 5, 10, 19, 28), (1, 2, 21), (3, 4)],
)
def test_extract_features_taps_match(jax_params, taps) -> None:
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 3))
    x = x.astype(np.float32)
    ref = jax_extract(
        jax_params, jnp.asarray(x), taps,
        precision=jax.lax.Precision.HIGHEST,
    )
    params = vgg19.params_from_numpy(jax_params, "cpu")
    ours = extract_features(params, torch.from_numpy(x), taps)
    assert sorted(ours) == sorted(ref) == sorted(taps)
    for idx in taps:
        r = np.asarray(ref[idx])
        assert ours[idx].shape == r.shape
        assert ours[idx].is_contiguous()
        np.testing.assert_allclose(
            ours[idx].numpy(), r, rtol=0,
            atol=TAP_RTOL * float(np.abs(r).max()),
        )
