"""The port's Gram (plain version on the CPU) vs the Pallas kernel.

The JAX side runs ``gram_matrix_pallas`` in Pallas interpret mode, as
``tests/test_pallas_gram.py`` does; both get the same numpy inputs.
Tolerance: float32, rtol 1e-5 (sums over P in different orders).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu.constants import GRAM_MATRIX_CLAMP_MAX
from style_transfer_visualizer_tpu.ops.pallas_gram import gram_matrix_pallas
from style_transfer_visualizer_tpu_torch.ops import gram

RTOL = 1e-5

SHAPES = [
    (1, 16, 16, 64),
    (1, 20, 30, 128),
]


def _features(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(ours, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=RTOL, atol=RTOL * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("scale", [1.0, 40.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_backward_match_pallas(shape, scale) -> None:
    feats = _features(0, shape, scale)
    g_out = _features(1, (shape[-1], shape[-1]))

    def f(x):
        return jnp.sum(gram_matrix_pallas(x, interpret=True) * g_out)

    ref_g = gram_matrix_pallas(jnp.asarray(feats), interpret=True)
    ref_dx = jax.grad(f)(jnp.asarray(feats))

    xt = torch.from_numpy(feats).requires_grad_(True)
    ours = gram.gram_matrix(xt)
    (ours * torch.from_numpy(g_out)).sum().backward()
    _close(ours.detach().numpy(), ref_g)
    _close(xt.grad.numpy(), ref_dx)


def test_clamp_is_active_in_the_large_case() -> None:
    feats = _features(0, SHAPES[0], 40.0)
    raw = feats.reshape(-1, feats.shape[-1]).astype(np.float64)
    raw = raw.T @ raw
    assert (raw > GRAM_MATRIX_CLAMP_MAX).any()
    assert (raw <= GRAM_MATRIX_CLAMP_MAX).any()


@pytest.mark.parametrize(
    ("p", "c", "n_sm"),
    [(262144, 64, 132), (1024, 512, 132), (7, 64, 132), (65536, 128, 4)],
)
def test_split_covers_every_row(p, c, n_sm) -> None:
    splits, rows = gram.split_rows(p, c, n_sm)
    assert rows % 16 == 0
    assert splits * rows >= p
    assert (splits - 1) * rows < p


def test_kernel_wrapper_rejects_cpu_tensors() -> None:
    with pytest.raises(ValueError, match="CUDA"):
        gram.gram_kernel(torch.zeros((16, 8)), GRAM_MATRIX_CLAMP_MAX, 1.0)
