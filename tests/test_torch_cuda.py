"""The port's CUDA kernels and frame stream, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (it is
decided inside the fixture, never at import). On a machine with a card
and without the JAX test environment, run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Shapes are small and ragged (odd widths, channel counts that fill no
tile, C_in = 3 and C_out = 3 as in the first layer, a batch of 2) to
reach the kernels' bounds checks, and both ways of loading A (TMA when
C_in is a multiple of 32, gathered otherwise). Tolerance: float32,
max-abs error 1e-4 relative to the reference's largest magnitude (the
kernels compute 3xTF32, about 21 mantissa bits, and sum in another
order). cuDNN's TF32 is off for the plain conv. The frame stream's
pinned-buffer path delivers every frame, in order, into arrays of its
own (bit-equal).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX,
)
from style_transfer_visualizer_tpu_torch.media.stream import AsyncFrameStream
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    pack_stencil,
)
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


_CONV_SHAPES = [
    (1, 7, 13, 3, 64), (2, 9, 9, 17, 70), (1, 16, 40, 64, 5),
    (1, 12, 12, 64, 3), (2, 10, 9, 32, 128),
]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize(("n", "h", "w", "ci", "co"), _CONV_SHAPES)
def test_conv_kernel_matches_plain(cuda, n, h, w, ci, co, relu) -> None:
    x = _rand(0, n, h, w, ci)
    w9 = _rand(1, 9, ci, co, scale=0.2)
    b = _rand(2, co)
    before = conv3x3.launches.count
    _close(
        conv3x3.conv3x3_kernel(x, pack_stencil(w9), b, relu),
        conv3x3.conv3x3_plain(x, w9, b, relu),
    )
    assert conv3x3.launches.count == before + 1


@pytest.mark.parametrize(("n", "h", "w", "ci", "co"), _CONV_SHAPES)
def test_conv_kernel_mask_matches_plain(cuda, n, h, w, ci, co) -> None:
    x = _rand(11, n, h, w, ci)
    mask = _rand(12, n, h, w, ci)
    w9 = _rand(13, 9, ci, co, scale=0.2)
    _close(
        conv3x3.conv3x3_kernel(x, pack_stencil(w9), None, False, mask),
        conv3x3.conv3x3_plain(x, w9, None, False, mask),
    )


def test_conv_input_gradient_matches_cudnn(cuda) -> None:
    x = _rand(3, 2, 11, 10, 8)
    w9 = _rand(4, 9, 8, 24, scale=0.2)
    b = _rand(5, 24)
    g = _rand(6, 2, 11, 10, 24)
    xk = x.clone().requires_grad_(True)
    w9f = flip_stencil(w9)
    out = conv3x3.conv3x3_bias_relu(
        xk, w9, w9f, b, True, pack_stencil(w9), pack_stencil(w9f),
    )
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


@pytest.mark.parametrize(
    ("s", "p", "c", "scale"),
    [(3, 1000, 96, 1.0), (4, 4099, 64, 20.0), (2, 33, 130, 1.0),
     (5, 1980, 512, 1.0)],
)
def test_gram_kernel_batched_matches_plain(cuda, s, p, c, scale) -> None:
    """One launch for S images; P not a multiple of the 32-row slot.

    Image s's last slab must not read image s+1's first rows: each
    image is scaled differently, so a row read across would show.
    """
    f = _rand(11, s, p, c, scale=scale)
    f = f * torch.arange(1, s + 1, device="cuda", dtype=f.dtype)[:, None, None]
    norm = float(p * c)
    before = gram.launches.count
    raw_k, g_k = gram.gram_kernel_batched(f, GRAM_MATRIX_CLAMP_MAX, norm)
    assert gram.launches.count == before + 1
    raw_p, g_p = gram.gram_plain_batched(f, GRAM_MATRIX_CLAMP_MAX, norm)
    for i in range(s):
        _close(raw_k[i], raw_p[i])
        _close(g_k[i], g_p[i])
        assert torch.equal(raw_k[i], raw_k[i].T)
    # At S = 1 the batched launch is the single one, bit for bit.
    raw_1, _ = gram.gram_kernel_batched(f[:1], GRAM_MATRIX_CLAMP_MAX, norm)
    raw_s, _ = gram.gram_kernel(f[0], GRAM_MATRIX_CLAMP_MAX, norm)
    assert torch.equal(raw_1[0], raw_s)
    # The backward, per image, against autograd through the plain Gram.
    feats = f.reshape(s, 1, p, c)
    dg = _rand(12, s, c, c)
    fk = feats.clone().requires_grad_(True)
    gram.gram_matrix_batched(fk).backward(dg)
    fr = feats.clone().requires_grad_(True)
    flat = fr.reshape(s, p, c)
    (torch.clamp(flat.mT @ flat, max=GRAM_MATRIX_CLAMP_MAX) / norm).backward(
        dg,
    )
    _close(fk.grad, fr.grad)


def test_wrappers_reject_non_contiguous_input(cuda) -> None:
    x = _rand(8, 1, 8, 8, 4).transpose(1, 2)
    w9 = _rand(9, 9, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_kernel(x, pack_stencil(w9), None, False)
    with pytest.raises(ValueError, match="contiguous"):
        gram.gram_kernel(_rand(10, 8, 16).T, GRAM_MATRIX_CLAMP_MAX, 1.0)


def test_stream_pinned_path_on_the_card(cuda) -> None:
    stream = AsyncFrameStream(max_queue=2)
    got: list[np.ndarray] = []
    src = torch.arange(64 * 48 * 3, device=cuda).reshape(64, 48, 3)
    for i in range(12):
        stream.submit(((src + i) % 256).to(torch.uint8), got.append)
    stream.close()
    assert stream._pool is not None  # noqa: SLF001
    assert stream._pool.shape == (64, 48, 3)  # noqa: SLF001
    want = src.cpu().numpy()
    for i, frame in enumerate(got):
        np.testing.assert_array_equal(
            frame, ((want + i) % 256).astype(np.uint8),
        )
    assert len({id(f) for f in got}) == 12


def test_stream_batches_on_the_card(cuda) -> None:
    stream = AsyncFrameStream()  # batches of 4, 9 pinned buffers
    got: list[tuple[int, np.ndarray]] = []
    src = torch.arange(32 * 16 * 3, device=cuda).reshape(32, 16, 3)
    for i in range(20):
        stream.submit(
            ((src + i) % 256).to(torch.uint8),
            lambda f, i=i: got.append((i, f)),
        )
        if i == 12:
            stream.drain()  # delivers the staged frames too
            assert [j for j, _ in got] == list(range(13))
    stream.close()
    assert [i for i, _ in got] == list(range(20))
    want = src.cpu().numpy()
    for i, frame in got:
        np.testing.assert_array_equal(
            frame, ((want + i) % 256).astype(np.uint8),
        )
        assert frame.flags.writeable
    got[0][1][:] = 0  # a sink's write reaches no other frame
    assert all(f.any() for _, f in got[1:])
