"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (it is
decided inside the fixture, never at import). On a machine with a card
and without the JAX test environment, run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Shapes are small and ragged (odd widths, channel counts that fill no
tile, a batch of 2) to reach the kernels' bounds checks. Tolerance:
float32, max-abs error 1e-4 relative to the reference's largest
magnitude (sums in different orders). cuDNN's TF32 is off for the
plain conv.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import flip_stencil
from style_transfer_visualizer_tpu_torch.ops import conv3x3, gram

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(ours: torch.Tensor, ref: torch.Tensor) -> None:
    err = float((ours - ref).abs().max())
    assert err <= TOL * max(float(ref.abs().max()), 1e-30)


def _rand(seed: int, *shape: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.tensor(
        (rng.normal(size=shape) * scale).astype(np.float32), device="cuda",
    )


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(
    ("n", "h", "w", "ci", "co"),
    [(1, 7, 13, 3, 64), (2, 9, 9, 17, 70), (1, 16, 40, 64, 5)],
)
def test_conv_kernel_matches_plain(cuda, n, h, w, ci, co, relu) -> None:
    x = _rand(0, n, h, w, ci)
    w9 = _rand(1, 9, ci, co, scale=0.2)
    b = _rand(2, co)
    before = conv3x3.launches.count
    _close(
        conv3x3.conv3x3_kernel(x, w9, b, relu),
        conv3x3.conv3x3_plain(x, w9, b, relu),
    )
    assert conv3x3.launches.count == before + 1


def test_conv_input_gradient_matches_cudnn(cuda) -> None:
    x = _rand(3, 2, 11, 10, 8)
    w9 = _rand(4, 9, 8, 24, scale=0.2)
    b = _rand(5, 24)
    g = _rand(6, 2, 11, 10, 24)
    xk = x.clone().requires_grad_(True)
    out = conv3x3.conv3x3_bias_relu(xk, w9, flip_stencil(w9), b, True)
    out.backward(g)
    xr = x.clone().requires_grad_(True)
    ref = conv3x3.conv3x3_plain(xr, w9, b, False)
    ref.backward(g * (out.detach() > 0))
    _close(xk.grad, xr.grad)


@pytest.mark.parametrize(
    ("p", "c", "scale"),
    [(1000, 96, 1.0), (4099, 64, 20.0), (33, 130, 1.0)],
)
def test_gram_kernel_matches_plain(cuda, p, c, scale) -> None:
    f = _rand(7, p, c, scale=scale)
    before = gram.launches.count
    raw_k, g_k = gram.gram_kernel(f, GRAM_MATRIX_CLAMP_MAX, float(p * c))
    raw_p, g_p = gram.gram_plain(f, GRAM_MATRIX_CLAMP_MAX, float(p * c))
    _close(raw_k, raw_p)
    _close(g_k, g_p)
    assert torch.equal(raw_k, raw_k.T)
    assert gram.launches.count == before + 1


def test_wrappers_reject_non_contiguous_input(cuda) -> None:
    x = _rand(8, 1, 8, 8, 4).transpose(1, 2)
    w9 = _rand(9, 9, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_kernel(x, w9, None, False)
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_kernel(_rand(10, 8, 16).T, GRAM_MATRIX_CLAMP_MAX, 1.0)
