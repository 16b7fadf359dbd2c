"""ReLU and 2x2/stride-2 max pooling on NHWC, in plain PyTorch.

The port of the JAX package's ``ops/pool.py``. The pool's backward sends
each output's gradient to the FIRST maximal element of its window in
row-major order, written out here rather than left to
``max_pool2d``'s own tie rule, so ties route as in the JAX package.
"""
from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU whose gradient is ``g * (x > 0)`` (0 at ``x == 0``)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, x, zero)


def _window_index(device: torch.device) -> torch.Tensor:
    """Row-major position (0..3) of each element of a 2x2 window."""
    return torch.arange(4, device=device, dtype=torch.uint8).reshape(
        1, 1, 2, 1, 2, 1,
    )


class _MaxPoolEven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        """Pool an even-sized map; keep the first maximum's position."""
        n, h, w, c = x.shape
        xr = x.reshape(n, h // 2, 2, w // 2, 2, c)
        out = xr.amax(dim=(2, 4))
        iota = _window_index(x.device)
        eq = xr == out[:, :, None, :, None, :]
        masked = torch.where(eq, iota, torch.full_like(iota, 4))
        ctx.save_for_backward(masked.amin(dim=(2, 4)))
        return out

    @staticmethod
    def backward(ctx, g):
        """Route each gradient to its window's first maximum."""
        (argfirst,) = ctx.saved_tensors
        n, h2, w2, c = g.shape
        hit = _window_index(g.device) == argfirst[:, :, None, :, None, :]
        grad = torch.where(
            hit, g[:, :, None, :, None, :],
            torch.zeros((), dtype=g.dtype, device=g.device),
        )
        return grad.reshape(n, h2 * 2, w2 * 2, c)


def maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool of an NHWC map, floor semantics.

    The crop to even dimensions stays outside the custom backward:
    slicing differentiates to zero padding.
    """
    _, h, w, _ = x.shape
    return _MaxPoolEven.apply(x[:, : (h // 2) * 2, : (w // 2) * 2, :])
