"""The port's 3x3 conv (plain version on the CPU) vs the Pallas kernel.

The JAX side runs ``conv3x3_bias_relu`` in Pallas interpret mode, as
``tests/test_pallas_conv.py`` does; both get the same numpy inputs.
Tolerance: float32, 1e-5 relative to the output's largest magnitude
(the two sum the 9*C_in products in different orders).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.ops.pallas_conv import (
    conv3x3_bias_relu as jax_conv,
    hwio_to_stencil,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    pack_stencil,
)
from style_transfer_visualizer_tpu_torch.ops import conv3x3

RTOL = 1e-5


def _inputs(seed, h, w, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    g = rng.normal(size=(1, h, w, co)).astype(np.float32)
    return x, wt, b, g


def _close(ours: np.ndarray, ref: np.ndarray) -> None:
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=RTOL * scale)


def _torch_conv(x, wt, b, relu):
    w9 = torch.from_numpy(wt.reshape(9, *wt.shape[2:]))
    w9f = flip_stencil(w9)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv3x3.conv3x3_bias_relu(
        xt, w9, w9f, torch.from_numpy(b), relu, pack_stencil(w9),
        pack_stencil(w9f),
    )
    return xt, out


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    ("h", "w", "ci", "co"), [(16, 16, 8, 16), (12, 20, 3, 8)],
)
def test_forward_matches_pallas(h, w, ci, co, relu) -> None:
    x, wt, b, _ = _inputs(0, h, w, ci, co)
    ref = jax_conv(
        jnp.asarray(x), hwio_to_stencil(jnp.asarray(wt)), jnp.asarray(b),
        relu, True,
    )
    _, out = _torch_conv(x, wt, b, relu)
    _close(out.detach().numpy(), np.asarray(ref))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    ("h", "w", "ci", "co"), [(16, 16, 8, 16), (12, 20, 3, 8)],
)
def test_input_gradient_matches_pallas(h, w, ci, co, relu) -> None:
    import jax  # noqa: PLC0415

    x, wt, b, g = _inputs(1, h, w, ci, co)
    w9j = hwio_to_stencil(jnp.asarray(wt))

    def f(xx):
        out = jax_conv(xx, w9j, jnp.asarray(b), relu, True)
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.grad(f)(jnp.asarray(x))
    xt, out = _torch_conv(x, wt, b, relu)
    (out * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), np.asarray(ref))


def test_cpu_tensor_takes_plain_version() -> None:
    x, wt, b, _ = _inputs(2, 8, 8, 4, 4)
    before = conv3x3.launches.count
    _torch_conv(x, wt, b, True)
    assert conv3x3.launches.count == before


def test_kernel_wrapper_rejects_cpu_tensors() -> None:
    x, wt, b, _ = _inputs(3, 8, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.conv3x3_kernel(
            torch.from_numpy(x),
            pack_stencil(torch.from_numpy(wt.reshape(9, 4, 4))),
            torch.from_numpy(b), True,
        )
