"""Total-variation regularizer on the optimized image.

The port of the JAX package's ``ops/tv.py``: the squared anisotropic
total variation of the working image, weighted by ``tv_w`` and added to
the objective after the VGG loss. It is computed in the model's working
space (the normalized tensor when ``normalize`` is on), as there.
Plain PyTorch: a few elementwise passes over the image, which autograd
differentiates.
"""
from __future__ import annotations

import torch


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean squared anisotropic total variation of an NHWC image.

    ``mean((x[h+1] - x[h])^2) + mean((x[w+1] - x[w])^2)``: each mean
    runs over its own difference field, in float32, so the weight's
    meaning does not depend on the resolution.
    """
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    return (
        torch.mean(torch.square(dy.float()))
        + torch.mean(torch.square(dx.float()))
    )


def tv_loss_per_image(x: torch.Tensor) -> torch.Tensor:
    """:func:`tv_loss` of each image of an NHWC batch: ``(N,)``.

    The multi-style batch's term: each style's image has its own TV,
    as the JAX package's ``vmap`` of ``tv_loss`` over the style axis
    gives it.
    """
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    return (
        torch.mean(torch.square(dy.float()), dim=(1, 2, 3))
        + torch.mean(torch.square(dx.float()), dim=(1, 2, 3))
    )
