"""Laplacian-steered loss: keep the content's fine edge structure.

The port of the JAX package's ``ops/lap.py`` ("Lapstyle", Li et al.
2017, arXiv:1707.01253): the mean squared difference between the
Laplacian responses of the working image and of the content image, each
taken after a ``pool x pool`` mean pool. The target response is made
once from the content image; the term touches only the pooled image,
never a VGG activation. Plain PyTorch (a reshape-mean and shifted-slice
adds), differentiated by autograd; all math in float32.
"""
from __future__ import annotations

import torch

# The 3x3 stencil needs a pooled image of at least this many pixels a
# side.
_MIN_POOLED = 3


def _avg_pool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """Non-overlapping ``pool x pool`` mean pooling of an NHWC tensor.

    Trailing rows and columns that do not fill a window are cropped
    (VALID), as in the JAX package's reshape-and-mean.
    """
    if pool <= 1:
        return x
    b, h, w, c = x.shape
    hp, wp = h // pool, w // pool
    x = x[:, : hp * pool, : wp * pool, :]
    return x.reshape(b, hp, pool, wp, pool, c).mean(dim=(2, 4))


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """3x3 VALID 4-neighbour Laplacian stencil of an NHWC tensor.

    ``up + down + left + right - 4 * center`` as shifted slices, in the
    JAX package's order of sums; one row and column are dropped at each
    edge.
    """
    center = x[:, 1:-1, 1:-1, :]
    up = x[:, :-2, 1:-1, :]
    down = x[:, 2:, 1:-1, :]
    left = x[:, 1:-1, :-2, :]
    right = x[:, 1:-1, 2:, :]
    return (up + down) + (left + right) - 4.0 * center


def lap_response(img: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Laplacian response of an NHWC image, in float32.

    Raises ``ValueError`` when the pooled image is smaller than 3x3.
    """
    x = _avg_pool(img.float(), pool)
    if x.shape[1] < _MIN_POOLED or x.shape[2] < _MIN_POOLED:
        msg = (
            f"lap_pool={pool} leaves a {x.shape[1]}x{x.shape[2]} pooled "
            f"image from {img.shape[1]}x{img.shape[2]} input — the 3x3 "
            "Laplacian stencil needs at least 3x3; lower --lap-pool."
        )
        raise ValueError(msg)
    return laplacian_filter(x)


def lap_loss(
    img: torch.Tensor,
    target_response: torch.Tensor,
    pool: int = 4,
) -> torch.Tensor:
    """Mean squared Laplacian mismatch against a precomputed target.

    ``target_response`` is ``lap_response(content, pool)``; the mean
    runs over the response's own element count.
    """
    diff = lap_response(img, pool) - target_response
    return torch.mean(torch.square(diff))


def lap_loss_per_image(
    img: torch.Tensor,
    target_response: torch.Tensor,
    pool: int = 4,
) -> torch.Tensor:
    """:func:`lap_loss` of each image of an NHWC batch: ``(N,)``.

    ``target_response`` is one content's response, ``(1, h, w, 3)``,
    shared by every image (the multi-style batch's). Image by image, so
    each image's pooled response, which its gradient reads, is the
    single run's, bit for bit.
    """
    return torch.stack([
        lap_loss(img[i:i + 1], target_response, pool)
        for i in range(img.shape[0])
    ])
