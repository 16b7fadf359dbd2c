"""The first steps of the configured optimizers, written out plainly.

Each function runs ``steps`` steps from ``x0`` and returns, per step,
the ``(total, style, content)`` loss at the point the step evaluates:
the loss reported for step ``k`` is the loss before the step's update.

L-BFGS is ``torch.optim.LBFGS`` with one iteration a step and no line
search: the first step goes along ``-g`` with length
``min(1, 1/|g|_1) * lr``; every later one takes the pair ``(s, y)`` of
the last step into a ring of ``history_size`` pairs stored in
``history_dtype`` (when ``y . s > 1e-10``), scales by ``gamma = y . s /
y . y``, and goes along ``-H g`` from the compact form of Byrd, Nocedal
and Schnabel (1994), with length ``lr``: the ring's products take the
stored pairs and ``g`` rounded to the ring's type, and the two
coefficient vectors are rounded to it before the combination
(:func:`compact_direction`). A step whose direction is not a descent
direction (``g . d > -1e-9``) leaves ``x`` where it is.

Adam is ``torch.optim.Adam``'s update (0.9, 0.999, eps 1e-8 outside the
square root, bias-corrected).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

Losses = list[tuple[float, float, float]]


def value_and_grad(objective: Callable, shape: tuple[int, ...]):
    """``x (n,) -> ((total, style, content) floats, grad (n,))``."""

    def vag(x: torch.Tensor):
        leaf = x.detach().reshape(shape).requires_grad_(True)
        total, style, content = objective(leaf)
        (grad,) = torch.autograd.grad(total, leaf)
        losses = (float(total.detach()), float(style.detach()), float(content.detach()))
        return losses, grad.reshape(-1)

    return vag


def compact_direction(g, s_ring, y_ring, gamma, ring_dtype):
    """``-H g`` from the pairs ``s_ring``, ``y_ring`` (oldest first, in
    the ring's type) and the scaling ``gamma``. The ring's products and
    the two triangular solves run in float64 (the stored pairs and the
    rounded ``g`` are exact there), so the reference's own rounding
    stays far below the port's; the coefficients are then rounded to
    the ring's type and the direction combined in fp32, as stated."""
    s64, y64 = s_ring.double(), y_ring.double()
    g_r = g.to(ring_dtype).double()
    gamma64 = gamma.double()
    sy = s64 @ y64.T
    r_mat = torch.triu(sy)
    u = torch.linalg.solve_triangular(
        r_mat, (s64 @ g_r)[:, None], upper=True,
    )[:, 0]
    rhs = torch.diagonal(sy) * u + gamma64 * ((y64 @ y64.T) @ u) - gamma64 * (
        y64 @ g_r
    )
    w = torch.linalg.solve_triangular(r_mat.T, rhs[:, None], upper=False)[:, 0]
    w = w.to(ring_dtype).float()
    u = u.to(ring_dtype).float()
    return -(gamma * g + w @ s_ring.float() - gamma * (u @ y_ring.float()))


def lbfgs_losses(
    vag, x0: torch.Tensor, steps: int, *, lr: float, history_size: int,
    history_dtype: torch.dtype,
) -> Losses:
    x = x0.reshape(-1).clone()
    pairs: list[tuple[torch.Tensor, torch.Tensor]] = []
    gamma = torch.ones((), device=x.device)
    prev_g = direction = step = None
    out: Losses = []
    for k in range(steps):
        losses, g = vag(x)
        out.append(losses)
        if k == 0:
            direction = -g
            step = torch.clamp(1.0 / g.abs().sum(), max=1.0) * lr
        else:
            y = g - prev_g
            s = direction * step
            ys, yy = torch.dot(y, s), torch.dot(y, y)
            if ys > 1e-10:  # noqa: PLR2004
                pairs = [*pairs, (s.to(history_dtype), y.to(history_dtype))]
                pairs = pairs[-history_size:]
                gamma = ys / yy
            if pairs:
                direction = compact_direction(
                    g, torch.stack([p[0] for p in pairs]),
                    torch.stack([p[1] for p in pairs]), gamma, history_dtype,
                )
            else:
                direction = -gamma * g
            step = torch.full((), lr, device=x.device)
        if torch.dot(g, direction) <= -1e-9:  # noqa: PLR2004
            x = x + step * direction
        prev_g = g
    return out


def adam_losses(vag, x0: torch.Tensor, steps: int, *, lr: float) -> Losses:
    x = x0.reshape(-1).clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    out: Losses = []
    for k in range(1, steps + 1):
        losses, g = vag(x)
        out.append(losses)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * torch.square(g)
        m_hat = m / (1 - 0.9**k)
        v_hat = v / (1 - 0.999**k)
        x = x - lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
    return out
